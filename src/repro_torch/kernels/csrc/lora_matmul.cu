// Fused LoRA matmul y = x @ W + scale * cast(x @ A -> B's type) @ B, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/lora_matmul.py::_kernel (wrapper
// lora_matmul). It computes the same function: the main product and the
// rank-r product xa = x @ A accumulate over K in f32; xa is rounded to B's
// type before xa @ B (as the Pallas kernel's xa_ref.astype(b_ref.dtype)); the
// sum acc + scale * (xa @ B) is taken in f32 and rounded once to the output
// type (x's type).
//
// Layout: x (M, K) row-major; W (K, N) row-major, or with w_trans = 1 the
// buffer of W^T, (N, K) row-major, so that the backward's dx = dy @ W^T needs
// no transposed copy of a frozen weight; A (K, r); B (r, N); out (M, N).
// Ragged M, N, K and r are handled by predicated loads (zeros outside the
// matrix) and predicated stores; nothing is padded in device memory.
//
// What bounds it: tensor-core operations. At the training path's shapes
// (M = 2048, K and N in {1024, 4096, 14336}, r = 16) it does 2*M*K*N flops on
// (M*K + K*N + M*N) * 2 bytes: ~1,000-1,700 flops per byte, far above the
// card's ~295 flops/byte ridge in bf16.
// Design for that bound:
//   * bf16: one CTA of 8 warps per 128 x 128 output tile; each warp owns a
//     64 x 32 sub-tile as 4 x 2 WMMA 16x16x16 bf16 fragments with f32
//     accumulators (tensor cores through mma.sync). K advances in tiles of
//     32; the next tile is loaded into registers (16-byte loads) while the
//     current one is multiplied from shared memory;
//   * xa for the CTA's 128 rows accumulates in the same K loop, one 16-row
//     block per warp, from an A tile loaded beside the x tile;
//   * f32 (small shapes only: tests and checks) runs a plain FMA tile loop,
//     no tensor cores: TF32 would miss the f32 tolerance.
// What does not carry over from the TPU: the Pallas kernel builds xa only on
// the n == 0 block and reuses it from scratch memory, relying on the grid
// running in order. CTAs run in no order, so each CTA recomputes xa for its
// rows: r / BLOCK_N more tensor-core work than the main product, 12.5 % at
// r = 16 and a 128-wide N tile.
// Known limits: WMMA and register-staged loads, not wgmma/TMA, so the kernel
// runs well below the card's peak; r <= 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 64;

// ------------------------------------------------------------ bf16 path --
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kPad = 8;            // bf16 elements of padding per shared row

template <int RP>
struct __align__(128) SmemBf16 {
  float stage[kWarps][16 * 16];    // per-warp fragment staging (f32)
  union {
    struct {
      bf16 x[kBM][kBK + kPad];     // x tile: rows m, columns k
      union {
        bf16 w[kBK][kBN + kPad];   // W tile: rows k, columns n
        bf16 wt[kBN][kBK + kPad];  // W^T tile: rows n, columns k
      };
      bf16 a[kBK][RP + kPad];      // A tile: rows k, columns r
    } main;
    struct {
      bf16 xa[kBM][RP + kPad];     // xa rounded to B's type
      bf16 b[RP][kBN + kPad];      // B tile
    } epi;
  };
};

union Chunk {
  uint4 v;
  unsigned short h[8];
};

// Eight consecutive elements of row `row`, columns col..col+7, of a
// row-major (rows x cols) matrix with leading dimension ld; zero outside.
__device__ __forceinline__ uint4 load_chunk(const bf16* base, int rows, int cols, int ld,
                                            int row, int col, bool vec_ok) {
  Chunk c;
  c.v = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows && col < cols) {
    const bf16* p = base + static_cast<size_t>(row) * ld + col;
    if (vec_ok && col + 8 <= cols) {
      c.v = *reinterpret_cast<const uint4*>(p);
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      for (int i = 0; i < 8; ++i)
        if (col + i < cols) c.h[i] = q[i];
    }
  }
  return c.v;
}

template <int RP, bool kTrans>
__global__ void __launch_bounds__(kThreads)
lora_matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const bf16* __restrict__ a, const bf16* __restrict__ b,
                        bf16* __restrict__ out, int M, int N, int K, int r, float scale) {
  __shared__ SmemBf16<RP> sm;
  constexpr int kRF = RP / 16;                  // 16-wide fragments of xa
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;    // 2 x 4 warps
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  const bool x_vec = (K % 8) == 0;
  const bool w_vec = kTrans ? (K % 8) == 0 : (N % 8) == 0;
  const bool a_vec = (r % 8) == 0;
  const bool b_vec = (N % 8) == 0;

  // global -> registers for K tile k0: two x chunks, two W chunks, <= 1 A chunk
  uint4 rx[2], rw[2], ra;
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * kThreads;
      rx[q] = load_chunk(x, M, K, K, m0 + c / 4, k0 + (c % 4) * 8, x_vec);
      if constexpr (kTrans)
        rw[q] = load_chunk(w, N, K, K, n0 + c / 4, k0 + (c % 4) * 8, w_vec);
      else
        rw[q] = load_chunk(w, K, N, N, k0 + c / 16, n0 + (c % 16) * 8, w_vec);
    }
    if (tid < kBK * (RP / 8))
      ra = load_chunk(a, K, r, r, k0 + tid / (RP / 8), (tid % (RP / 8)) * 8, a_vec);
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * kThreads;
      *reinterpret_cast<uint4*>(&sm.main.x[c / 4][(c % 4) * 8]) = rx[q];
      if constexpr (kTrans)
        *reinterpret_cast<uint4*>(&sm.main.wt[c / 4][(c % 4) * 8]) = rw[q];
      else
        *reinterpret_cast<uint4*>(&sm.main.w[c / 16][(c % 16) * 8]) = rw[q];
    }
    if (tid < kBK * (RP / 8))
      *reinterpret_cast<uint4*>(&sm.main.a[tid / (RP / 8)][(tid % (RP / 8)) * 8]) = ra;
  };

  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                         typename std::conditional<kTrans, wmma::col_major,
                                                   wmma::row_major>::type> FragW;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

  Acc acc[4][2];
  Acc xacc[kRF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
  for (int j = 0; j < kRF; ++j) wmma::fill_fragment(xacc[j], 0.f);

  const int n_k = (K + kBK - 1) / kBK;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) load_tile((kt + 1) * kBK);   // in flight behind the MMAs
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[4];
      FragW fw[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &sm.main.x[warp_m * 64 + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (kTrans)
          wmma::load_matrix_sync(fw[j], &sm.main.wt[warp_n * 32 + j * 16][kk], kBK + kPad);
        else
          wmma::load_matrix_sync(fw[j], &sm.main.w[kk][warp_n * 32 + j * 16], kBN + kPad);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fw[j], acc[i][j]);
      // xa rows warp*16 .. +15 (every CTA recomputes its rows' xa)
      FragA fx;
      wmma::load_matrix_sync(fx, &sm.main.x[warp * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < kRF; ++j) {
        FragB fa_r;
        wmma::load_matrix_sync(fa_r, &sm.main.a[kk][j * 16], RP + kPad);
        wmma::mma_sync(xacc[j], fx, fa_r, xacc[j]);
      }
    }
    __syncthreads();
    if (kt + 1 < n_k) {
      store_tile();
      __syncthreads();
    }
  }

  // ---- epilogue: xa -> B's type, then acc += scale * xa @ B, one rounding
  float* st = sm.stage[warp];
#pragma unroll
  for (int j = 0; j < kRF; ++j) {
    wmma::store_matrix_sync(st, xacc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      sm.epi.xa[warp * 16 + e / 16][j * 16 + e % 16] = __float2bfloat16(st[e]);
    __syncwarp();
  }
  for (int c = tid; c < RP * (kBN / 8); c += kThreads) {
    const int row = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
    *reinterpret_cast<uint4*>(&sm.epi.b[row][col]) = load_chunk(b, r, N, N, row, n0 + col, b_vec);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Acc lacc;
      wmma::fill_fragment(lacc, 0.f);
#pragma unroll
      for (int jr = 0; jr < kRF; ++jr) {
        FragA fxa;
        FragB fb;
        wmma::load_matrix_sync(fxa, &sm.epi.xa[warp_m * 64 + i * 16][jr * 16], RP + kPad);
        wmma::load_matrix_sync(fb, &sm.epi.b[jr * 16][warp_n * 32 + j * 16], kBN + kPad);
        wmma::mma_sync(lacc, fxa, fb, lacc);
      }
#pragma unroll
      for (int t = 0; t < acc[i][j].num_elements; ++t) acc[i][j].x[t] += scale * lacc.x[t];
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = m0 + warp_m * 64 + i * 16, col0 = n0 + warp_n * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + e / 16, col = col0 + e % 16;
        if (row < M && col < N) out[static_cast<size_t>(row) * N + col] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- f32 path --
constexpr int fBM = 64, fBN = 64, fBK = 16;

template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
lora_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int M, int N, int K, int r, float scale) {
  __shared__ float xs[fBM][fBK + 1];
  __shared__ float ws[fBK][fBN + 1];
  __shared__ float as[fBK][kMaxRank + 1];
  __shared__ float xas[fBM][kMaxRank + 1];
  __shared__ float bs[kMaxRank][fBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;       // thread owns rows ty+16i, cols tx+16j
  const int m0 = blockIdx.y * fBM, n0 = blockIdx.x * fBN;
  constexpr int kXaPer = fBM * kMaxRank / kThreads;    // xa entries per thread
  float acc[4][4] = {};
  float xr[kXaPer] = {};

  for (int k0 = 0; k0 < K; k0 += fBK) {
    for (int e = tid; e < fBM * fBK; e += kThreads) {
      const int row = e / fBK, col = e % fBK;
      const int gm = m0 + row, gk = k0 + col;
      xs[row][col] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    for (int e = tid; e < fBK * fBN; e += kThreads) {
      const int row = e / fBN, col = e % fBN;
      const int gk = k0 + row, gn = n0 + col;
      float v = 0.f;
      if (gk < K && gn < N)
        v = kTrans ? w[static_cast<size_t>(gn) * K + gk] : w[static_cast<size_t>(gk) * N + gn];
      ws[row][col] = v;
    }
    for (int e = tid; e < fBK * r; e += kThreads) {
      const int row = e / r, col = e % r;
      const int gk = k0 + row;
      as[row][col] = gk < K ? a[static_cast<size_t>(gk) * r + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < fBK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int q = 0; q < kXaPer; ++q) {
      const int e = tid + q * kThreads;
      if (e < fBM * r) {
        const int row = e / r, col = e % r;
        float s = xr[q];
        for (int kk = 0; kk < fBK; ++kk) s = fmaf(xs[row][kk], as[kk][col], s);
        xr[q] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kXaPer; ++q) {
    const int e = tid + q * kThreads;
    if (e < fBM * r) xas[e / r][e % r] = xr[q];   // B's type is f32: no rounding
  }
  for (int e = tid; e < r * fBN; e += kThreads) {
    const int row = e / fBN, col = e % fBN;
    const int gn = n0 + col;
    bs[row][col] = gn < N ? b[static_cast<size_t>(row) * N + gn] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ty + 16 * i, col = tx + 16 * j;
      float l = 0.f;
      for (int c = 0; c < r; ++c) l = fmaf(xas[row][c], bs[c][col], l);
      const int gm = m0 + row, gn = n0 + col;
      if (gm < M && gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j] + scale * l;
    }
  }
}

template <int RP>
cudaError_t launch_bf16(const void* x, const void* w, const void* a, const void* b, void* out,
                        int M, int N, int K, int r, bool trans, float scale, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (trans)
    lora_matmul_bf16_kernel<RP, true><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(a),
        static_cast<const bf16*>(b), static_cast<bf16*>(out), M, N, K, r, scale);
  else
    lora_matmul_bf16_kernel<RP, false><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(a),
        static_cast<const bf16*>(b), static_cast<bf16*>(out), M, N, K, r, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, A, B and out share it). w_trans: 1
// when `w` holds W^T as an (N, K) row-major buffer. Pointers must be 16-byte
// aligned. Returns a cudaError_t (0 on success).
extern "C" int repro_lora_matmul(const void* x, const void* w, const void* a, const void* b,
                                 void* out, int dtype, int m, int n, int k, int r, int w_trans,
                                 float scale, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || r <= 0 || r > kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool trans = w_trans != 0;
  if (dtype == 0) {
    const dim3 grid((n + fBN - 1) / fBN, (m + fBM - 1) / fBM);
    if (trans)
      lora_matmul_f32_kernel<true><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), m, n, k, r, scale);
    else
      lora_matmul_f32_kernel<false><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), m, n, k, r, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    if (r <= 16) return static_cast<int>(launch_bf16<16>(x, w, a, b, out, m, n, k, r, trans, scale, s));
    if (r <= 32) return static_cast<int>(launch_bf16<32>(x, w, a, b, out, m, n, k, r, trans, scale, s));
    return static_cast<int>(launch_bf16<64>(x, w, a, b, out, m, n, k, r, trans, scale, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
