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
// K and V rows once, B * L * 2 * KV * hd * bytes, and does g flops per bf16
// byte of them (7 for qwen2.5-7b): far below the card's ~295 flops/byte
// ridge. So the work is to keep enough bytes in flight on all 132 SMs and
// to spend few instructions and shared-memory reads on each byte. Both
// kernels below split each sequence's positions across CTAs (flash-
// decoding): the grid is (kv head, sequence, split), a split a fixed run of
// `split_tokens` positions that the wrapper plans from the table's width, B,
// KV and the row bytes alone (`_k1_splits`), so the host never reads
// `lengths`, and the launch is capturable in a CUDA graph. Each split writes
// its partial (m, l, acc) in f32 to a workspace; a second small kernel, one
// CTA per (sequence, head), rescales and sums the partials of the splits
// below the sequence's length. So a call makes two device launches, each
// named `paged_decode_*` (the benchmark finds K1's device time by that
// name).
//
// bf16 with hd % 16 == 0 and g <= 16 (every attention family the port
// serves) takes the tensor-core kernel, `paged_decode_mma_kernel`:
//   * the g query heads of a KV head are one side of an m16n8k16 mma.sync
//     tile: the products are taken transposed, S^T = K Q^T and O^T = V^T
//     P^T, so the heads are the n side, 8 wide (one n tile for g <= 8, two
//     for g <= 16, zero columns past g), and 16 positions or 16 dims the m
//     side. Scores are bf16 products, exact in f32, summed in f32: the
//     CUDA-core kernel's up to the order of summation. Each K/V element is
//     read from shared memory once per CTA, not once per head of the group;
//   * P V keeps the softmax weights at f32 precision: P is split into bf16
//     hi + mid + lo (24 bits together, K3's split carried one term further,
//     so the bf16 output differs from the plain version no more than the
//     CUDA-core kernel's does), each moved from the scores' C fragment to a
//     B fragment by `movmatrix`, and all three go through the MMA into one
//     f32 accumulator: never P rounded once to bf16;
//   * copies: tiles of 64 positions (one page of the serving cache) by
//     16-byte cp.async, zero-filled where a row is invalid (a -1 page, past
//     the split), through a ring of kMmaStages (2) stages; each tile's copies
//     are issued before the wait for the one before it, so two tiles are in
//     flight at each wait. Two stages (70 KB at hd 128) let three CTAs share
//     an SM; three stages (104 KB) leave two, and measured slower on the
//     card (PERF.md). Warp w of four owns rows 16w..16w+15 of every tile: it
//     reads each row's page-table entry one tile ahead, copies the rows, and
//     keeps its own online softmax (m, l, acc) with q in registers, so the
//     loop has no CTA barrier; the four warps merge once at the end, through
//     shared memory;
//   * splits hold at least SPLIT_BYTES (128 KB) of K/V of their KV head,
//     shorter only where the grid would otherwise leave SMs idle, so the
//     pipeline's fill and the partial are small beside the reads; a CTA past
//     its sequence's length reads `lengths[b]` and exits, writing nothing
//     (the combine reads no partial there).
//
// f32 inputs (tensor cores take no f32 operand without TF32's loss) and the
// bf16 shapes the MMA tile does not take go to the CUDA-core kernel,
// `paged_decode_split_kernel`, with the same plan and combine:
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
//     in f32 FMAs on the CUDA cores, each K/V element widened and multiplied
//     once per head of the group.
// Known limits: the CUDA-core kernel g * hd <= 4096 (the accumulators of a
// thread); the partials cost an extra (hd + 2) * 4 bytes per (head, split)
// written and read, which stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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


// ---------------------------------------------------------------------------
// The tensor-core kernel: bf16, hd a multiple of 16, g <= 16 (see the note at
// the top). One CTA of four warps per (kv head, sequence, split); the split's
// positions come in tiles of 64 (one page of the serving cache) through a
// ring of kMmaStages stages, and warp w owns rows 16w..16w+15 of every tile:
// it copies them, computes on them and keeps its own (m, l, acc), so the loop
// synchronises warps only, never the CTA. The products are taken transposed,
// S^T = K Q^T and O^T = V^T P^T, so that the g heads are the n side of an
// m16n8k16 tile: one n tile of 8 heads where g <= 8 (NT = 1), two where
// g <= 16, and the 16 positions of a warp's rows or of hd the m side. Scores
// are kept in log2 units (scale * log2(e) folded in); the partial's m is
// written back in natural units, in the layout `paged_decode_combine_kernel`
// reads.

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kWarpRows = 16;                      // positions of a tile per warp
constexpr int kPageTile = kWarpRows * kMmaWarps;   // 64 positions: a tile
constexpr int kMmaStages = 2;
constexpr int kMmaGroup = 16;                      // query heads: two n tiles at most
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kLog2e = 1.442695040888963407f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8q..8q+7 give the row
// addresses of matrix q. `_t` transposes each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// An 8 x 8 bf16 matrix held as a fragment (lane l: row l / 4, columns
// 2 (l % 4) and + 1, in one register), transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v0, v1) as bf16 pairs hi + mid + lo, each the bf16 rounding of what the
// ones before it leave: 24 bits of the f32 value together (v0 in the low
// half of each).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// HDMAX (64, 128 or 256) sizes the accumulators, NT (1 or 2) the n tiles of
// heads; hd <= HDMAX and g <= 8 NT are the call's.
template <int HDMAX, int NT>
__global__ void __launch_bounds__(kMmaThreads)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pages,
                        const __nv_bfloat16* __restrict__ v_pages,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ lengths, float* __restrict__ part,
                        int n_pages, int ptok, int pool_pages, int kv_heads, int g, int hd,
                        int split_tokens, float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr int kSteps = HDMAX / 16;             // 16-wide steps of hd, at most
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;    // a fragment's row, and its column pair
  const int steps = hd / 16;
  const int cpr = hd / 8;                        // 16-byte chunks of a row
  const int rmul = (65536 + cpr - 1) / cpr;      // i / cpr == (i * rmul) >> 16 for i < 16 cpr
  const int ld = hd + 8;                         // rows padded by 16 bytes: ldmatrix's eight
                                                 // row reads fall in distinct banks
  const int total = n_pages * ptok;
  const int s0 = split * split_tokens;
  const size_t head0 = (static_cast<size_t>(b) * kv_heads + kvh) * g;   // first q head

  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);    // kMmaStages x 64 x ld
  bf16* v_s = k_s + kMmaStages * kPageTile * ld;
  __shared__ unsigned valid_s[kMmaWarps][kMmaStages];   // a warp's rows of a stage: valid bits
  __shared__ float m_s[kMmaWarps][kMmaGroup];
  __shared__ float l_s[kMmaWarps][kMmaGroup];

  // q^T as the B fragments of S^T = K q^T: head 8 j + grp, dims 2 quad and
  // + 1 (then + 8) of each 16-wide step; heads past g are zeros
  uint32_t qb[NT][kSteps][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const bool real = 8 * j + grp < g;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + (head0 + 8 * j + grp) * hd) + quad;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      qb[j][kk][0] = real && kk < steps ? qr[kk * 8] : 0u;
      qb[j][kk][1] = real && kk < steps ? qr[kk * 8 + 4] : 0u;
    }
  }

  // Lane r (and r + 16) follows row r of the warp's 16 rows of each tile:
  // its page-table entry is read one tile ahead of its copies, so no copy
  // waits on the table (the first tile's, like q, before `lengths`).
  const int32_t* table = page_table + static_cast<size_t>(b) * n_pages;
  int pos = 0, pg = -1, off = 0;                 // the next tile's row: position, page, offset
  auto look_up = [&](int tile) {
    pos = s0 + tile * kPageTile + warp * kWarpRows + (lane & 15);
    pg = -1;
    if (pos < total) {
      const int pi = pos / ptok;
      pg = __ldg(table + pi);
      off = pos - pi * ptok;
    }
  };
  look_up(0);

  const int len = min(lengths[b], total);
  if (s0 >= len) return;   // past the sequence's end: the combine reads no partial here
  const int s1 = min(s0 + split_tokens, len);
  const int n_tiles = (s1 - s0 + kPageTile - 1) / kPageTile;

  // The warp's 16 rows of tile `tile` into stage `st`: each lane copies
  // hd / 16 chunks of K and of V, zero-filled where the row is invalid (a
  // -1 page, past the split).
  auto issue = [&](int tile, int st) {
    int tok = -1;                                // the row's position in the pool
    if (pos < s1 && pg >= 0) {
      if (pg >= pool_pages) __trap();            // a caller's bug: never read outside the pool
      tok = pg * ptok + off;
    }
    look_up(tile + 1);
    const unsigned valid = __ballot_sync(kAll, tok >= 0) & 0xffffu;
    if (valid) {
      const int row0 = (st * kPageTile + warp * kWarpRows) * ld;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (j < steps) {                         // 16 rows x cpr chunks = 32 steps chunks
          const int i = lane + 32 * j;
          const int r = (i * rmul) >> 16, c = i - r * cpr;
          const int rt = __shfl_sync(kAll, tok, r);
          const size_t src =
              rt >= 0 ? (static_cast<size_t>(rt) * kv_heads + kvh) * hd + c * 8 : 0;
          cp_async16(k_s + row0 + r * ld + c * 8, k_pages + src, rt >= 0);
          cp_async16(v_s + row0 + r * ld + c * 8, v_pages + src, rt >= 0);
        }
      }
    }
    if (lane == 0) valid_s[warp][st] = valid;
  };

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_tiles) issue(st, st);
    cp_async_commit();
  }

  // O^T: dims 16 mt + grp (+ 8) x heads 8 j + 2 quad (+ 1)
  float acc[NT][kSteps][4];
  float m[NT][2], l[NT][2];                      // heads 8 j + 2 quad + e
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) acc[j][mt][0] = acc[j][mt][1] = acc[j][mt][2] = acc[j][mt][3] = 0.f;
    m[j][0] = m[j][1] = -INFINITY;
    l[j][0] = l[j][1] = 0.f;
  }
  // each lane's ldmatrix row address in the warp's rows: K as A (positions
  // 0-15, dims 0-7 then 8-15), V^T as A by transposed loads (positions 0-7,
  // then 8-15, of dims 0-7 then 8-15)
  const int k_off = (lane & 15) * ld + (lane >> 4) * 8;
  const int v_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    __syncwarp();                                // the warp is done with the stage it refills
    if (it + kMmaStages - 1 < n_tiles)
      issue(it + kMmaStages - 1, (it + kMmaStages - 1) % kMmaStages);
    cp_async_commit();
    cp_async_wait<kMmaStages - 1>();             // this tile's rows, the later ones in flight
    __syncwarp();
    const int st = it % kMmaStages;
    const unsigned valid = valid_s[warp][st];
    if (!valid) continue;
    const bf16* kt = k_s + (st * kPageTile + warp * kWarpRows) * ld;
    const bf16* vt = v_s + (st * kPageTile + warp * kWarpRows) * ld;

    // S^T = K q^T: 16 positions x 8 heads per n tile
    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk < steps) {
        uint32_t a[4];
        ldsm_x4(a, kt + k_off + kk * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma16816(s[j], a, qb[j][kk][0], qb[j][kk][1]);
      }
    }

    // online softmax per head: s[j][e] and s[j][2 + e] are positions grp and
    // grp + 8 of head 8 j + 2 quad + e; the 8 lanes of a quad column hold
    // the head's 16 positions
    const bool ok0 = (valid >> grp) & 1u, ok1 = (valid >> (grp + 8)) & 1u;
    uint32_t ph[NT][2], pm[NT][2], pl[NT][2];    // P^T as B fragments: positions 0-7, 8-15
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x0 = ok0 ? s[j][e] * scale_log2 : -INFINITY;
        const float x1 = ok1 ? s[j][2 + e] * scale_log2 : -INFINITY;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 16));
        const float now = fmaxf(m[j][e], mx);
        const float base = now == -INFINITY ? 0.f : now;   // nothing valid yet: no NaN
        const float alpha = exp2f(m[j][e] - base);
        m[j][e] = now;
        s[j][e] = exp2f(x0 - base);
        s[j][2 + e] = exp2f(x1 - base);
        l[j][e] = l[j][e] * alpha + s[j][e] + s[j][2 + e];   // the lane's share
#pragma unroll
        for (int mt = 0; mt < kSteps; ++mt) {
          if (mt < steps) {
            acc[j][mt][e] *= alpha;
            acc[j][mt][2 + e] *= alpha;
          }
        }
      }
      // the f32 weights as bf16 hi + mid + lo, each 8 x 8 block transposed
      // from the C fragment (a position's heads) to the B one (a head's
      // positions)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t hi, mid, lo;
        split3(s[j][2 * h], s[j][2 * h + 1], hi, mid, lo);
        ph[j][h] = movmatrix_t(hi);
        pm[j][h] = movmatrix_t(mid);
        pl[j][h] = movmatrix_t(lo);
      }
    }

    // O^T += V^T P^T, three MMAs (lo, mid, hi) into one f32 accumulator
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      if (mt < steps) {
        uint32_t a[4];
        ldsm_x4_t(a, vt + v_off + mt * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma16816(acc[j][mt], a, pl[j][0], pl[j][1]);
          mma16816(acc[j][mt], a, pm[j][0], pm[j][1]);
          mma16816(acc[j][mt], a, ph[j][0], ph[j][1]);
        }
      }
    }
  }

  // merge the four warps' (m, l, acc) into the split's partial
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[j][e] += __shfl_xor_sync(kAll, l[j][e], 4);
      l[j][e] += __shfl_xor_sync(kAll, l[j][e], 8);
      l[j][e] += __shfl_xor_sync(kAll, l[j][e], 16);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free: it holds the warps' acc
  float* o_s = reinterpret_cast<float*>(smem4);  // kMmaWarps x g x hd
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int h = 8 * j + 2 * quad + e;
      if (h < g) {
        float* oh = o_s + (warp * g + h) * hd + grp;
#pragma unroll
        for (int mt = 0; mt < kSteps; ++mt) {
          if (mt < steps) {
            oh[16 * mt] = acc[j][mt][e];
            oh[16 * mt + 8] = acc[j][mt][2 + e];
          }
        }
        if (grp == 0) {
          m_s[warp][h] = m[j][e];
          l_s[warp][h] = l[j][e];
        }
      }
    }
  }
  __syncthreads();
  const int n_splits = gridDim.z;
  const size_t part_head = static_cast<size_t>(n_splits) * (hd + 2);   // stride of a head
  float* part0 = part + head0 * part_head + static_cast<size_t>(split) * (hd + 2);
  if (tid < g) {                                 // m_s becomes each warp's weight
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, m_s[w][tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float wt = mx == -INFINITY ? 0.f : exp2f(m_s[w][tid] - mx);
      m_s[w][tid] = wt;
      sum += wt * l_s[w][tid];
    }
    part0[tid * part_head] = sum > 0.f ? mx * kLn2 : kNegInf;
    part0[tid * part_head + 1] = sum;
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kMmaThreads) {
    const int h = i / hd, d = i - h * hd;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) a = fmaf(m_s[w][h], o_s[(w * g + h) * hd + d], a);
    part0[h * part_head + 2 + d] = a;
  }
}

template <int HDMAX, int NT>
cudaError_t launch_mma_kernel(const void* q, const void* k_pages, const void* v_pages,
                              const void* page_table, const void* lengths, float* workspace,
                              int batch, int kv_heads, int g, int hd, int n_pages, int ptok,
                              int pool_pages, int n_splits, int split_tokens, float scale,
                              cudaStream_t stream) {
  const auto kernel = paged_decode_mma_kernel<HDMAX, NT>;
  const size_t smem = sizeof(__nv_bfloat16) * 2 * kMmaStages * kPageTile * static_cast<size_t>(hd + 8);
  static int granted[kMaxDevices] = {};
  cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(kernel), smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(kv_heads, batch, n_splits);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), workspace, n_pages, ptok, pool_pages, kv_heads, g, hd,
      split_tokens, scale * kLog2e);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mma_nt(const void* q, const void* k_pages, const void* v_pages,
                          const void* page_table, const void* lengths, float* ws, int batch,
                          int kv_heads, int g, int hd, int n_pages, int ptok, int pool_pages,
                          int n_splits, int split_tokens, float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch_mma_kernel<64, NT>(q, k_pages, v_pages, page_table, lengths, ws, batch, kv_heads,
                                     g, hd, n_pages, ptok, pool_pages, n_splits, split_tokens,
                                     scale, stream);
  if (hd <= 128)
    return launch_mma_kernel<128, NT>(q, k_pages, v_pages, page_table, lengths, ws, batch,
                                      kv_heads, g, hd, n_pages, ptok, pool_pages, n_splits,
                                      split_tokens, scale, stream);
  return launch_mma_kernel<256, NT>(q, k_pages, v_pages, page_table, lengths, ws, batch, kv_heads,
                                    g, hd, n_pages, ptok, pool_pages, n_splits, split_tokens,
                                    scale, stream);
}

int launch_mma(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
               const void* lengths, void* out, void* workspace, int batch, int kv_heads, int g,
               int hd, int n_pages, int ptok, int pool_pages, int n_splits, int split_tokens,
               float scale, cudaStream_t stream) {
  if (batch <= 0 || kv_heads <= 0 || g <= 0 || g > kMmaGroup || hd <= 0 || hd > kMaxHeadDim ||
      hd % 16 != 0 || n_splits <= 0 || n_splits > kMaxSplits || split_tokens <= 0 ||
      workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* ws = static_cast<float*>(workspace);
  const cudaError_t err =
      g <= 8 ? launch_mma_nt<1>(q, k_pages, v_pages, page_table, lengths, ws, batch, kv_heads, g,
                                hd, n_pages, ptok, pool_pages, n_splits, split_tokens, scale,
                                stream)
             : launch_mma_nt<2>(q, k_pages, v_pages, page_table, lengths, ws, batch, kv_heads, g,
                                hd, n_pages, ptok, pool_pages, n_splits, split_tokens, scale,
                                stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine_kernel<__nv_bfloat16><<<batch * kv_heads * g, kCombineThreads, 0, stream>>>(
      ws, static_cast<const int32_t*>(lengths), static_cast<__nv_bfloat16*>(out), kv_heads * g,
      hd, n_splits, split_tokens, n_pages * ptok);
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

// The tensor-core kernel (bf16 only; hd % 16 == 0, g <= 16), then the same
// combine kernel. Arguments and workspace as above.
extern "C" int repro_paged_decode_attention_mma(const void* q, const void* k_pages,
                                                const void* v_pages, const void* page_table,
                                                const void* lengths, void* out, void* workspace,
                                                int batch, int kv_heads, int g, int hd,
                                                int n_pages, int ptok, int pool_pages,
                                                int n_splits, int split_tokens, float scale,
                                                void* stream) {
  return launch_mma(q, k_pages, v_pages, page_table, lengths, out, workspace, batch, kv_heads, g,
                    hd, n_pages, ptok, pool_pages, n_splits, split_tokens, scale,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
