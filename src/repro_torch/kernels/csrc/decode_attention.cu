// Paged GQA flash-decode attention for one layer, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::_kernel
// (wrapper paged_decode_attention). It computes the same function:
//   out[b, h] = softmax(scale * q[b, h] . K[b, :len]) V[b, :len]
// where K/V of sequence b are the pages page_table[b, :] of the pool,
// pages with a table entry of -1 are skipped, and positions >= lengths[b]
// are masked. The online softmax (m, l, acc) runs in f32; the result is
// acc / max(l, 1e-30), so a row with nothing valid gives 0; the output is
// cast to q's type.
//
// Layout: q (B, H, hd); k/v pages (P, ptok, KV, hd); page_table
// (B, n_pages) int32; lengths (B,) int32; out (B, H, hd). H = KV * g, and
// the g query heads of one KV head are consecutive in q and out.
//
// What bounds it: HBM bytes. Per layer the kernel must read the valid
// K and V rows once, B * L * 2 * KV * hd * bytes, and does ~4 flops per
// byte of them: far below the card's ~295 flops/byte ridge in bf16.
// Design for that bound:
//   * one CTA per (kv head, sequence): it loads its own page table entries
//     and length, and walks the pages in tiles of kTile tokens, so K/V rows
//     are read exactly once and the g query heads of the group share them
//     (the Pallas kernel's GQA grouping);
//   * each tile is read with 16-byte vector loads, and the next tile's
//     loads are issued into registers before the current tile is computed,
//     so one tile of loads is always in flight behind the arithmetic;
//   * scores and the PV product run from shared memory in f32 (no tensor
//     cores: g x kTile is far below a wgmma tile, and the bound is bytes).
// Known limit: B * KV CTAs (64 for llama3-8b at 8 slots) fill under half of
// the 132 SMs, so at decode batch sizes most SMs idle. Splitting the KV
// range across CTAs with a combine pass (flash-decoding) is a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;         // tokens per tile; == warp width (softmax step)
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Widens one 16-byte load to f32 (bf16 is the high half of an f32; the
// lower-addressed element sits in the low bits).
template <typename T> __device__ __forceinline__ void unpack(const uint4& r, float* dst);
template <> __device__ __forceinline__ void unpack<float>(const uint4& r, float* dst) {
  dst[0] = __uint_as_float(r.x);
  dst[1] = __uint_as_float(r.y);
  dst[2] = __uint_as_float(r.z);
  dst[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r, float* dst) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Moves (p, t0) to the next tile that holds at least one valid token.
// The walk is the same in every thread of the block. A table entry past the
// pool is a caller's bug: the kernel traps, so the next synchronisation
// raises, instead of reading outside the pool.
__device__ __forceinline__ bool next_tile(const int32_t* __restrict__ table, int n_pages,
                                          int ptok, int pool_pages, int length, int& p,
                                          int& t0, int& page, int& nt) {
  t0 += kTile;
  while (p < n_pages) {
    const int valid = min(ptok, length - p * ptok);
    const int pg = table[p];
    if (pg >= pool_pages) __trap();
    if (pg >= 0 && t0 < valid) {
      page = pg;
      nt = min(kTile, valid - t0);
      return true;
    }
    ++p;
    t0 = 0;
  }
  return false;
}

template <typename T>
struct TileLoader {
  static constexpr int kVec = 16 / sizeof(T);                              // elements per load
  static constexpr int kLoads = kTile * kMaxHeadDim / (kVec * kThreads);   // per thread
  uint4 k[kLoads];
  uint4 v[kLoads];

  // Issues the loads of tokens [t0, t0 + nt) of `page` for KV head `kvh`.
  __device__ __forceinline__ void load(const T* __restrict__ kp, const T* __restrict__ vp,
                                       int page, int t0, int nt, int ptok, int kv_heads,
                                       int kvh, int hd) {
    const int per_row = hd / kVec;
    const int n = nt * per_row;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < n) {
        const int t = i / per_row;
        const int c = i - t * per_row;
        const size_t off =
            ((static_cast<size_t>(page) * ptok + t0 + t) * kv_heads + kvh) * hd + c * kVec;
        k[j] = *reinterpret_cast<const uint4*>(kp + off);
        v[j] = *reinterpret_cast<const uint4*>(vp + off);
      }
    }
  }

  // Writes the loaded rows to shared memory as f32, row stride `row`.
  __device__ __forceinline__ void store(float* k_s, float* v_s, int nt, int hd, int row) const {
    const int per_row = hd / kVec;
    const int n = nt * per_row;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < n) {
        const int t = i / per_row;
        const int d = (i - t * per_row) * kVec;
        unpack<T>(k[j], k_s + t * row + d);
        unpack<T>(v[j], v_s + t * row + d);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths, T* __restrict__ out, int n_pages,
                    int ptok, int pool_pages, int kv_heads, int g, int hd, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = hd + 1;   // padded row: a warp reading one column hits 32 banks

  extern __shared__ float smem[];
  float* q_s = smem;                   // g * hd
  float* acc_s = q_s + g * hd;         // g * hd
  float* k_s = acc_s + g * hd;         // kTile * row
  float* v_s = k_s + kTile * row;      // kTile * row
  float* p_s = v_s + kTile * row;      // g * kTile: scores, then weights
  float* m_s = p_s + g * kTile;        // g
  float* l_s = m_s + g;                // g
  float* alpha_s = l_s + g;            // g

  const size_t head0 = (static_cast<size_t>(b) * kv_heads + kvh) * g;   // first q head
  const T* qb = q + head0 * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const int length = lengths[b];
  const int32_t* table = page_table + static_cast<size_t>(b) * n_pages;

  TileLoader<T> ld;
  int p = 0, t0 = -kTile, page = 0, nt = 0;
  bool have = next_tile(table, n_pages, ptok, pool_pages, length, p, t0, page, nt);
  if (have) ld.load(k_pages, v_pages, page, t0, nt, ptok, kv_heads, kvh, hd);
  __syncthreads();

  while (have) {
    ld.store(k_s, v_s, nt, hd, row);
    const int cur = nt;
    have = next_tile(table, n_pages, ptok, pool_pages, length, p, t0, page, nt);
    if (have) ld.load(k_pages, v_pages, page, t0, nt, ptok, kv_heads, kvh, hd);   // in flight
    __syncthreads();

    // scores: one (head, token) pair per thread
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int h = i / kTile;
      const int t = i - h * kTile;
      float s = kNegInf;
      if (t < cur) {
        const float* qh = q_s + h * hd;
        const float* kt = k_s + t * row;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qh[d], kt[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per head, one lane per token of the tile
    for (int h = warp; h < g; h += kWarps) {
      const float s = p_s[h * kTile + lane];
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float e = lane < cur ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(e);
      p_s[h * kTile + lane] = e;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one (head, dim) pair per thread
    for (int i = tid; i < g * hd; i += kThreads) {
      const int h = i / hd;
      const int d = i - h * hd;
      const float* ph = p_s + h * kTile;
      float a = acc_s[i] * alpha_s[h];
      for (int t = 0; t < cur; ++t) a = fmaf(ph[t], v_s[t * row + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + head0 * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    ob[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
           const void* lengths, void* out, int batch, int kv_heads, int g, int hd, int n_pages,
           int ptok, int pool_pages, float scale, cudaStream_t stream) {
  if (batch <= 0 || kv_heads <= 0 || g <= 0 || hd <= 0 || hd > kMaxHeadDim ||
      (hd * sizeof(T)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(g) * hd + 2 * kTile * (hd + 1) + g * kTile + 3 * g);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(kv_heads, batch);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(page_table), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), n_pages, ptok, pool_pages, kv_heads, g, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* page_table,
                                            const void* lengths, void* out, int dtype,
                                            int batch, int kv_heads, int g, int hd,
                                            int n_pages, int ptok, int pool_pages,
                                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_table, lengths, out, batch, kv_heads, g, hd,
                         n_pages, ptok, pool_pages, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, out, batch,
                                 kv_heads, g, hd, n_pages, ptok, pool_pages, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
