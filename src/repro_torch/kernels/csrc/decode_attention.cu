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
// byte of them: far below the card's ~295 flops/byte ridge in bf16. At
// decode batch sizes there are few (kv head, sequence) pairs (64 for
// llama3-8b at 8 slots, 8 at one slot), so the design splits each
// sequence's positions across CTAs (flash-decoding) to put enough loads in
// flight on all 132 SMs:
//   * the grid is (kv head, sequence, split); a split is a fixed run of
//     `split_tokens` positions (64: one page of the serving cache), chosen
//     by the wrapper from n_pages and ptok alone, so the host never reads
//     `lengths`. A split that starts past its sequence's length writes an
//     empty partial (m = -1e30, l = 0) and exits;
//   * a split CTA keeps the g query heads of its KV head together (the
//     Pallas kernel's GQA grouping), so each K/V row is read once; it looks
//     up its own page-table entries and reads its rows in tiles of 32
//     tokens with 16-byte cp.async copies, double-buffered: the next
//     tile's copies are in flight while the current one is computed.
//     Invalid positions (a -1 page, past the length) are zero-filled by the
//     copy and masked out of the softmax;
//   * scores (one thread per (head, token), 16-byte reads of K rows padded
//     by 16 bytes, so the 32 rows a warp reads fall in distinct banks) and
//     the PV product (one (head, dim pair) per thread, in registers) run
//     in f32 on the CUDA cores: g x 32 is far below a tensor-core tile, and
//     the bound is bytes;
//   * each split writes its partial (m, l, acc) in f32 to a workspace; a
//     second small kernel, one CTA per (sequence, head), rescales and sums
//     the partials of the splits below the sequence's length (one split
//     too: it goes through the same combine). So a call makes two device
//     launches.
// Known limits: g * hd <= 4096 (the accumulators of a thread); the partials
// cost an extra (hd + 2) * 4 bytes per (head, split) written and read, which
// stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // tokens per tile
constexpr int kMaxHeadDim = 256;
constexpr int kMaxPairs = 8;       // (head, dim pair) accumulators per thread
constexpr int kMaxSplits = 64;
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;

// The dynamic shared memory `kernel` may take, raised once per device to
// the most any call asked for (`granted` holds it, by device). The
// attribute call is host work: made per launch it would come with every
// call, and with every launch captured into a CUDA graph.
constexpr int kMaxDevices = 64;
cudaError_t opt_in_smem(const void* kernel, size_t bytes, int* granted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) granted[dev] = static_cast<int>(bytes);
  return err;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Widens one 16-byte load to f32 (bf16 is the high half of an f32; the
// lower-addressed element sits in the low bits).
__device__ __forceinline__ void unpack(const uint4& r, float* dst, float) {
  dst[0] = __uint_as_float(r.x);
  dst[1] = __uint_as_float(r.y);
  dst[2] = __uint_as_float(r.z);
  dst[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* dst, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Elements d and d + 1 of a row, as f32 (d even).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes global -> shared, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The pool page holding position `pos` of a sequence, or -1 for a skipped
// page. A table entry past the pool is a caller's bug: the kernel traps, so
// the next synchronisation raises, instead of reading outside the pool.
__device__ __forceinline__ int page_of(const int32_t* __restrict__ table, int pos, int ptok,
                                       int pool_pages) {
  const int pg = table[pos / ptok];
  if (pg >= pool_pages) __trap();
  return pg;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages, const int32_t* __restrict__ page_table,
                          const int32_t* __restrict__ lengths, float* __restrict__ part,
                          int n_pages, int ptok, int pool_pages,
                          int kv_heads, int g, int hd, int split_tokens, float scale) {
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = (static_cast<size_t>(b) * kv_heads + kvh) * g;   // first q head
  const int s0 = split * split_tokens;
  const int s1 = min(s0 + split_tokens, min(lengths[b], n_pages * ptok));
  const int n_pairs = g * hd / 2;
  float* part0 = part + head0 * n_splits * (hd + 2) + static_cast<size_t>(split) * (hd + 2);
  const size_t part_head = static_cast<size_t>(n_splits) * (hd + 2);   // stride of a head

  if (s0 >= s1) {   // nothing of this sequence here: an empty partial
    for (int h = tid; h < g; h += kThreads) {
      part0[h * part_head] = kNegInf;
      part0[h * part_head + 1] = 0.f;
    }
    return;
  }

  constexpr int kVec = 16 / sizeof(T);          // elements per 16 bytes
  const int ld = hd + kVec;                      // K/V rows padded by 16 bytes
  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);          // 2 buffers x kTile x ld
  T* v_s = k_s + 2 * kTile * ld;                 // 2 buffers x kTile x ld
  float* q_s = reinterpret_cast<float*>(v_s + 2 * kTile * ld);   // g x hd
  float* p_s = q_s + g * hd;                     // g x kTile: scores, then weights
  float* m_s = p_s + g * kTile;                  // g
  float* l_s = m_s + g;                          // g
  float* alpha_s = l_s + g;                      // g
  int* ok_s = reinterpret_cast<int*>(alpha_s + g);   // 2 x kTile: position valid

  const int32_t* table = page_table + static_cast<size_t>(b) * n_pages;
  const int per_row = hd / kVec;                 // 16-byte chunks per row
  auto load_tile = [&](int t0, int buf) {
    for (int i = tid; i < kTile * per_row; i += kThreads) {
      const int t = i / per_row, c = i - t * per_row;
      const int pos = t0 + t;
      int pg = -1;
      if (pos < s1) pg = page_of(table, pos, ptok, pool_pages);
      const bool valid = pg >= 0;
      const size_t off = valid ? ((static_cast<size_t>(pg) * ptok + pos % ptok) * kv_heads + kvh) *
                                         hd + c * kVec
                               : 0;
      const int dst = (buf * kTile + t) * ld + c * kVec;
      cp_async16(k_s + dst, k_pages + off, valid);
      cp_async16(v_s + dst, v_pages + off, valid);
      if (c == 0) ok_s[buf * kTile + t] = valid;
    }
    cp_async_commit();
  };

  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  load_tile(s0, 0);
  const T* qb = q + head0 * hd;
  for (int i = tid; i < g * hd; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int h = tid; h < g; h += kThreads) {
    m_s[h] = kNegInf;
    l_s[h] = 0.f;
  }
  float2 acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = make_float2(0.f, 0.f);

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int t0 = s0 + it * kTile;
    if (it + 1 < n_tiles) {
      load_tile(t0 + kTile, buf ^ 1);            // in flight behind this tile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: one thread per (head, token); a warp's lanes are the tile's
    // 32 tokens, reading K rows 16 bytes at a time (the padded rows put
    // each 8-lane phase in distinct banks) and q of one head (a broadcast)
    const int* ok_t = ok_s + buf * kTile;
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int h = i / kTile, t = i - h * kTile;
      const T* kr = k_s + (buf * kTile + t) * ld;
      const float* qh = q_s + h * hd;
      float dot = 0.f;
#pragma unroll 4
      for (int d = 0; d < hd; d += kVec) {
        float kf[kVec];
        unpack(*reinterpret_cast<const uint4*>(kr + d), kf, T());
#pragma unroll
        for (int j = 0; j < kVec; j += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qh + d + j);
          dot = fmaf(qq.x, kf[j], dot);
          dot = fmaf(qq.y, kf[j + 1], dot);
          dot = fmaf(qq.z, kf[j + 2], dot);
          dot = fmaf(qq.w, kf[j + 3], dot);
        }
      }
      p_s[i] = ok_t[t] ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head, one lane per token of the tile
    for (int h = warp; h < g; h += kWarps) {
      const bool ok = ok_t[lane];
      const float s = p_s[h * kTile + lane];
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(ok ? s : kNegInf));
      const float e = ok ? expf(s - m_new) : 0.f;
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

    // acc = acc * alpha + P V: (head, dim pair) accumulators in registers;
    // invalid rows of V are zeros and their weights 0
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int pi = tid + i * kThreads;
      if (pi < n_pairs) {
        const int h = 2 * pi / hd, d = 2 * pi - h * hd;
        const float* ph = p_s + h * kTile;
        const T* vr = v_s + buf * kTile * ld + d;
        const float alpha = alpha_s[h];
        float ax = acc[i].x * alpha, ay = acc[i].y * alpha;
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) {
          const float p = ph[t];
          const float2 vv = load_pair(vr + t * ld);
          ax = fmaf(p, vv.x, ax);
          ay = fmaf(p, vv.y, ay);
        }
        acc[i] = make_float2(ax, ay);
      }
    }
    __syncthreads();   // the next iteration's copies overwrite this buffer
  }

#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int pi = tid + i * kThreads;
    if (pi < n_pairs) {
      const int h = 2 * pi / hd, d = 2 * pi - h * hd;
      store_pair(part0 + h * part_head + 2 + d, acc[i].x, acc[i].y);
    }
  }
  for (int h = tid; h < g; h += kThreads) {
    part0[h * part_head] = m_s[h];
    part0[h * part_head + 1] = l_s[h];
  }
}

// One CTA per (sequence, q head): out = sum_s w_s acc_s / sum_s w_s l_s with
// w_s = exp(m_s - max m), over the splits below the sequence's length that
// saw a valid position (l_s > 0).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_decode_combine_kernel(const float* __restrict__ part, const int32_t* __restrict__ lengths,
                            T* __restrict__ out, int heads, int hd, int n_splits,
                            int split_tokens, int max_tokens) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float norm_s;
  const int head = blockIdx.x;                   // b * heads + h
  const int len = min(lengths[head / heads], max_tokens);
  const int n_valid = max(0, min(n_splits, (len + split_tokens - 1) / split_tokens));
  const float* ph = part + static_cast<size_t>(head) * n_splits * (hd + 2);
  if (threadIdx.x < 32) {                        // one warp: weights and their sum
    float m = kNegInf;
    for (int s = threadIdx.x; s < n_valid; s += 32)
      if (ph[s * (hd + 2) + 1] > 0.f) m = fmaxf(m, ph[s * (hd + 2)]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = threadIdx.x; s < n_valid; s += 32) {
      const float ls = ph[s * (hd + 2) + 1];
      const float w = ls > 0.f ? expf(ph[s * (hd + 2)] - m) : 0.f;
      w_s[s] = w;
      l += w * ls;
    }
    l = warp_sum(l);
    if (threadIdx.x == 0) norm_s = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < n_valid; ++s)
      if (w_s[s] > 0.f) a = fmaf(w_s[s], ph[s * (hd + 2) + 2 + d], a);
    out[static_cast<size_t>(head) * hd + d] = from_f32<T>(a * norm_s);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
           const void* lengths, void* out, void* workspace, int batch, int kv_heads, int g,
           int hd, int n_pages, int ptok, int pool_pages, int n_splits, int split_tokens,
           float scale, cudaStream_t stream) {
  if (batch <= 0 || kv_heads <= 0 || g <= 0 || hd <= 0 || hd > kMaxHeadDim ||
      (hd * sizeof(T)) % 16 != 0 || g * hd > 2 * kMaxPairs * kThreads || n_splits <= 0 ||
      n_splits > kMaxSplits || split_tokens <= 0 || workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * static_cast<size_t>(kTile) * (hd * sizeof(T) + 16) +
                      sizeof(float) * (static_cast<size_t>(g) * hd + g * kTile + 3 * g) +
                      sizeof(int) * 2 * kTile;
  static int granted[kMaxDevices] = {};  // one per T
  cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(paged_decode_split_kernel<T>),
                                smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kv_heads, batch, n_splits);
  paged_decode_split_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(page_table), static_cast<const int32_t*>(lengths),
      static_cast<float*>(workspace), n_pages, ptok, pool_pages, kv_heads, g, hd, split_tokens,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine_kernel<T><<<batch * kv_heads * g, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(workspace), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), kv_heads * g, hd, n_splits, split_tokens, n_pages * ptok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. workspace: n_splits * B * H * (hd + 2)
// floats. Returns a cudaError_t (0 on success).
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const void* page_table,
                                            const void* lengths, void* out, void* workspace,
                                            int dtype, int batch, int kv_heads, int g, int hd,
                                            int n_pages, int ptok, int pool_pages, int n_splits,
                                            int split_tokens, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_table, lengths, out, workspace, batch,
                         kv_heads, g, hd, n_pages, ptok, pool_pages, n_splits, split_tokens,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, out, workspace,
                                 batch, kv_heads, g, hd, n_pages, ptok, pool_pages, n_splits,
                                 split_tokens, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
