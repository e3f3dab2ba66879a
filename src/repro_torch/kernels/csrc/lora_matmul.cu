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
//
// What bounds it: tensor-core operations. At the training path's shapes
// (M = 2048, K and N in {1024, 4096, 14336}, r = 16) it does 2*M*K*N flops on
// (M*K + K*N + M*N) * 2 bytes: ~1,000-1,700 flops per byte, far above the
// card's ~295 flops/byte ridge in bf16. Only wgmma fed by TMA reaches the
// tensor cores' rate, so the main kernel is built on them.
//
// Three kernels; the wrapper picks one by shape before the launch (the
// `kernel` argument of repro_lora_matmul) and counts each:
//   * wgmma (bf16; K, N and r multiples of 8, r <= 64; every bf16 shape of
//     the training path): one persistent CTA per SM walks 128 x BN output
//     tiles (BN 256, or 128 where 256-wide tiles would leave SMs idle, as
//     at N = 1024). Warpgroup 2's first thread is the producer: it keeps a
//     ring of 3-6 stages in shared memory filled by TMA (128-byte swizzle;
//     per stage an x tile 128 x 64, a W tile 64 x BN and an A tile 64 x RP),
//     with an mbarrier full/empty pair per stage. Warpgroups 0 and 1 each
//     own 64 rows of the tile: per 16-deep K step one m64nBNk16 wgmma for
//     x @ W and one m64nRPk16 for x @ A into f32 registers, the next
//     stage's wgmma started before the last one is waited on. Both W forms
//     are wgmma's B operand: W (K, N) is read MN-major (transpose bit set,
//     BN/64 TMA boxes of 64 columns), W^T (N, K) K-major (one box).
//     Epilogue: xa is rounded to bf16 in registers, where its accumulator
//     fragment is already the A-operand fragment of a k16 wgmma, and
//     multiplied by the B tile (loaded by TMA into its own buffer while the
//     main loop runs) into the main accumulator, as
//       acc = (acc * (1/s) + xa @ B) * s,
//     since a second 64 x BN f32 accumulator would not fit in registers.
//     For s a power of two (alpha / r = 2 on the training path) both scalings
//     are exact; otherwise each adds one f32 rounding (relative 6e-8), far
//     below the output's bf16 rounding (4e-3) that the tolerances allow.
//     s = 0 skips the product. The tile is stored through a padded 64 x 32
//     staging buffer per warpgroup with 16-byte stores. Rows past M, and K
//     past the matrix, come in as TMA's zero fill; columns r..RP-1 of A and
//     rows r..RP-1 of B likewise, so xa's padding contributes 0;
//   * WMMA (bf16 shapes TMA cannot describe: a row of x, W, A or B that is
//     not a multiple of 16 bytes, as K, N or r not a multiple of 8, or r >
//     64 is refused): one CTA of 8 warps per 128 x 128 tile, WMMA 16x16x16
//     fragments with f32 accumulators, register-staged 16-byte loads,
//     predicated ragged M, N, K and r;
//   * f32 (small shapes only: tests and checks) runs a plain FMA tile loop,
//     no tensor cores: TF32 would miss the f32 tolerance.
// What does not carry over from the TPU: the Pallas kernel builds xa only on
// the n == 0 block and reuses it from scratch memory, relying on the grid
// running in order. CTAs run in no order, so each tile recomputes xa for its
// rows: r / BN more tensor-core work than the main product, 6 % at r = 16
// and a 256-wide tile.
// Known limits: the two consumer warpgroups share one tile, so a tile's
// epilogue does not overlap the next tile's wgmma (only its TMA loads); r <=
// 64; K, N, r multiples of 8 for the wgmma kernel.

#include <cuda.h>
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

// ----------------------------------------------------------- wgmma path --
// PTX helpers: shared-memory addresses, mbarriers, TMA loads, wgmma.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of `bar` with this parity has completed. A wait
// that lasts ~10 s (a fault in the pipeline) traps, so the next
// synchronisation raises instead of the launch hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// One TMA box at coordinates (c0 inner, c1 outer) into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma's start and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
// K-major with 128 B swizzle: rows of 64 bf16, 8-row groups SBO = 1024 B apart
// (LBO unused). MN-major: SBO = the stride of 8-deep K groups, LBO = the
// stride of swizzle-wide column blocks.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16: A from shared memory (K-major)
// or registers, B from shared memory (kTransB = 1: MN-major). Every
// accumulator register is an operand of the instruction, hence the lists.
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int gBM = 128, gBK = 64;
constexpr int gThreads = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int gSmemLimit = 232448;
constexpr int gOutCols = 32;       // epilogue staging: 64 x 32 per warpgroup,
constexpr int gOutLd = gOutCols + 8;   // rows padded by 16 B (no bank conflicts)

template <int BN, int RP>
struct WgCfg {
  static constexpr int kX = gBM * gBK * 2;          // x tile, K-major
  static constexpr int kW = gBK * BN * 2;           // W tile
  static constexpr int kA = gBK * RP * 2;           // A tile, MN-major
  static constexpr int kStage = kX + kW + kA;       // bytes per stage (TMA tx count)
  static constexpr int kB = RP * BN * 2;            // B tile for the epilogue
  static constexpr int kOut = 2 * 64 * gOutLd * 2;  // staging of both warpgroups
  static constexpr int kFixed = kB + kOut + 256 + 1024;   // + barriers + alignment
  static constexpr int kFit = (gSmemLimit - kFixed) / kStage;
  static constexpr int kStages = kFit > 6 ? 6 : kFit;
  static constexpr int kSmem = kStages * kStage + kFixed;
  static_assert(kStages >= 3, "too few pipeline stages");
  static_assert(kStage % 1024 == 0 && kX % 1024 == 0 && (kX + kW) % 1024 == 0, "alignment");
};

template <int BN, bool kTrans>
__device__ __forceinline__ void mma_main(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_ss_n256<kTrans ? 0 : 1>(acc, da, db);
  else wgmma_ss_n128<kTrans ? 0 : 1>(acc, da, db);
}
template <int RP>
__device__ __forceinline__ void mma_xa(float (&acc)[RP / 2], uint64_t da, uint64_t db) {
  if constexpr (RP == 64) wgmma_ss_n64<1>(acc, da, db);
  else if constexpr (RP == 32) wgmma_ss_n32<1>(acc, da, db);
  else wgmma_ss_n16<1>(acc, da, db);
}
template <int BN>
__device__ __forceinline__ void mma_epi(float (&acc)[BN / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (BN == 256) wgmma_rs_n256(acc, a, db);
  else wgmma_rs_n128(acc, a, db);
}

template <int BN, int RP, bool kTrans>
__global__ void __launch_bounds__(gThreads, 1)
lora_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b, bf16* __restrict__ out, int M,
                         int N, int K, float scale) {
  using Cfg = WgCfg<BN, RP>;
  constexpr int S = Cfg::kStages;
  constexpr uint32_t kSwA = RP == 64 ? 1 : RP == 32 ? 2 : 3;   // A tile rows are 2*RP bytes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* b_tile = smem + S * Cfg::kStage;
  bf16* staging = reinterpret_cast<bf16*>(b_tile + Cfg::kB);
  uint64_t* full = reinterpret_cast<uint64_t*>(b_tile + Cfg::kB + Cfg::kOut);
  uint64_t* empty = full + S;
  uint64_t* b_full = empty + S;
  uint64_t* b_empty = b_full + 1;

  const int m_tiles = (M + gBM - 1) / gBM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int n_kb = (K + gBK - 1) / gBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(b_full, 1);
    mbar_init(b_empty, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tiles in column-block-major order: the CTAs in flight share W's columns
  // and sweep all of x, which stays in L2.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0, b_phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * gBM, n0 = (t / m_tiles) * BN;
        for (int kb = 0; kb < n_kb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * Cfg::kStage;
          mbar_expect_tx(&full[stage], Cfg::kStage);
          const int k0 = kb * gBK;
          tma_load_2d(st, &tm_x, &full[stage], k0, m0);
          if constexpr (kTrans) {
            tma_load_2d(st + Cfg::kX, &tm_w, &full[stage], k0, n0);
          } else {
#pragma unroll
            for (int i = 0; i < BN / 64; ++i)
              tma_load_2d(st + Cfg::kX + i * 8192, &tm_w, &full[stage], n0 + 64 * i, k0);
          }
          tma_load_2d(st + Cfg::kX + Cfg::kW, &tm_a, &full[stage], 0, k0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
        // B's columns of this tile, once the previous tile's epilogue is done
        mbar_wait(b_empty, b_phase ^ 1);
        mbar_expect_tx(b_full, Cfg::kB);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          tma_load_2d(b_tile + i * RP * 128, &tm_b, b_full, n0 + 64 * i, 0);
        b_phase ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64*wg .. 64*wg+63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid / 32, lane = tid % 32;
    const float inv_scale = scale != 0.f ? 1.f / scale : 0.f;
    bf16* stg = staging + wg * 64 * gOutLd;
    const uint64_t d_b = make_desc(b_tile, RP * 128, 1024, 1);
    float acc[BN / 2];
    float xacc[RP / 2];
    int stage = 0;
    uint32_t phase = 0, b_phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * gBM, n0 = (t / m_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < RP / 2; ++i) xacc[i] = 0.f;
      int prev = 0;
      for (int kb = 0; kb < n_kb; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * Cfg::kStage;
        const uint64_t d_x = make_desc(st + wg * 8192, 16, 1024, 1);
        const uint64_t d_w = kTrans ? make_desc(st + Cfg::kX, 16, 1024, 1)
                                    : make_desc(st + Cfg::kX, 8192, 1024, 1);
        const uint64_t d_a = make_desc(st + Cfg::kX + Cfg::kW, gBK * RP * 2, 16 * RP, kSwA);
        fence_regs(acc);
        fence_regs(xacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < gBK / 16; ++kk)   // K-major: +32 B; MN-major: +16 rows
          mma_main<BN, kTrans>(acc, d_x + 2 * kk, d_w + (kTrans ? 2 : 128) * kk);
#pragma unroll
        for (int kk = 0; kk < gBK / 16; ++kk) mma_xa<RP>(xacc, d_x + 2 * kk, d_a + 2 * RP * kk);
        wgmma_commit();
        fence_regs(acc);
        fence_regs(xacc);
        wgmma_wait<1>();                        // the previous stage's products are done
        if (kb > 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(xacc);
      mbar_arrive(&empty[prev]);

      // ---- epilogue: acc += scale * bf16(xa) @ B, in the accumulator
      uint32_t xa[RP / 16][4];   // xa's accumulator fragment is wgmma's A fragment
#pragma unroll
      for (int kk = 0; kk < RP / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[kk][i] = pack_bf16(xacc[8 * kk + 2 * i], xacc[8 * kk + 2 * i + 1]);
      mbar_wait(b_full, b_phase);
      b_phase ^= 1;
      if (scale != 0.f) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] *= inv_scale;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RP / 16; ++kk) mma_epi<BN>(acc, xa[kk], d_b + 128 * kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] *= scale;
      }
      mbar_arrive(b_empty);

      // ---- store: 32 columns at a time through the staging buffer
      const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
      for (int c = 0; c < BN / gOutCols; ++c) {
#pragma unroll
        for (int jj = 0; jj < gOutCols / 8; ++jj) {
          const int j = c * (gOutCols / 8) + jj;   // n8 block of the accumulator
          *reinterpret_cast<uint32_t*>(&stg[row * gOutLd + 8 * jj + col]) =
              pack_bf16(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(&stg[(row + 8) * gOutLd + 8 * jj + col]) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = tid + 128 * i;           // 64 rows x 4 chunks of 8
          const int r_ = p / 4, ch = p % 4;
          const int gm = m0 + wg * 64 + r_, gn = n0 + c * gOutCols + ch * 8;
          if (gm < M && gn < N)
            *reinterpret_cast<uint4*>(out + static_cast<size_t>(gm) * N + gn) =
                *reinterpret_cast<const uint4*>(&stg[r_ * gOutLd + ch * 8]);
        }
        named_barrier(1 + wg, 128);
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// looked up through the runtime's entry-point query, so the library needs
// no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 matrix of `outer` rows of `inner` elements, `row_bytes` apart, read
// in boxes of box_inner x box_outer; zeros outside the matrix.
bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer, int row_bytes,
              int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device and its SM count, queried once per device.
constexpr int kMaxDevices = 64;
cudaError_t device_sms(int* dev, int* sms) {
  static int n_sm[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (n_sm[*dev] == 0) {
    err = cudaDeviceGetAttribute(&n_sm[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = n_sm[*dev];
  return cudaSuccess;
}

template <int BN, int RP>
cudaError_t launch_wgmma(const void* x, const void* w, const void* a, const void* b, void* out,
                         int M, int N, int K, int r, bool trans, float scale, int dev, int n_sm,
                         cudaStream_t s) {
  using Cfg = WgCfg<BN, RP>;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr CUtensorMapSwizzle kSwA = RP == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : RP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tx, tw, ta, tb;
  const bool ok = make_map(&tx, x, K, M, K * 2, gBK, gBM, kSw) &&
                  (trans ? make_map(&tw, w, K, N, K * 2, gBK, BN, kSw)
                         : make_map(&tw, w, N, K, N * 2, 64, gBK, kSw)) &&
                  make_map(&ta, a, r, K, r * 2, RP, gBK, kSwA) &&
                  make_map(&tb, b, N, r, N * 2, 64, RP, kSw);
  if (!ok) return cudaErrorInvalidValue;
  // the shared-memory opt-in, once per device
  static bool opted_in[kMaxDevices][2] = {};
  cudaError_t err = cudaSuccess;
  auto kern = trans ? lora_matmul_wgmma_kernel<BN, RP, true> : lora_matmul_wgmma_kernel<BN, RP, false>;
  if (!opted_in[dev][trans]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return err;
    opted_in[dev][trans] = true;
  }
  const int tiles = ((M + gBM - 1) / gBM) * ((N + BN - 1) / BN);
  const int grid = tiles < n_sm ? tiles : n_sm;
  kern<<<grid, gThreads, Cfg::kSmem, s>>>(tx, tw, ta, tb, static_cast<bf16*>(out), M, N, K, scale);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgmma_rank(const void* x, const void* w, const void* a, const void* b,
                              void* out, int M, int N, int K, int r, bool trans, float scale,
                              int dev, int n_sm, cudaStream_t s) {
  if (r <= 16) return launch_wgmma<BN, 16>(x, w, a, b, out, M, N, K, r, trans, scale, dev, n_sm, s);
  if (r <= 32) return launch_wgmma<BN, 32>(x, w, a, b, out, M, N, K, r, trans, scale, dev, n_sm, s);
  return launch_wgmma<BN, 64>(x, w, a, b, out, M, N, K, r, trans, scale, dev, n_sm, s);
}

// 128 x 256 output tiles where there are at least as many as SMs, else
// 128 x 128 (k/v's N = 1024 makes only 64 wide tiles).
cudaError_t launch_wgmma_width(const void* x, const void* w, const void* a, const void* b,
                               void* out, int M, int N, int K, int r, bool trans, float scale,
                               cudaStream_t s) {
  int dev = 0, n_sm = 0;
  const cudaError_t err = device_sms(&dev, &n_sm);
  if (err != cudaSuccess) return err;
  const long long tiles_256 = static_cast<long long>((M + gBM - 1) / gBM) * ((N + 255) / 256);
  if (tiles_256 >= n_sm)
    return launch_wgmma_rank<256>(x, w, a, b, out, M, N, K, r, trans, scale, dev, n_sm, s);
  return launch_wgmma_rank<128>(x, w, a, b, out, M, N, K, r, trans, scale, dev, n_sm, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, A, B and out share it). w_trans: 1
// when `w` holds W^T as an (N, K) row-major buffer. kernel: 0 = f32 FMA,
// 1 = WMMA, 2 = wgmma, which picks its tile width from the shape and the SM
// count (the wrapper chooses the kernel; one that cannot take the shape or
// dtype is refused, never replaced). Pointers must be 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int repro_lora_matmul(const void* x, const void* w, const void* a, const void* b,
                                 void* out, int dtype, int m, int n, int k, int r, int w_trans,
                                 int kernel, float scale, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || r <= 0 || r > kMaxRank || kernel < 0 || kernel > 2 ||
      (dtype == 0) != (kernel == 0) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool trans = w_trans != 0;
  if (kernel == 0) {
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
  if (kernel == 1) {
    if (r <= 16) return static_cast<int>(launch_bf16<16>(x, w, a, b, out, m, n, k, r, trans, scale, s));
    if (r <= 32) return static_cast<int>(launch_bf16<32>(x, w, a, b, out, m, n, k, r, trans, scale, s));
    return static_cast<int>(launch_bf16<64>(x, w, a, b, out, m, n, k, r, trans, scale, s));
  }
  if (k % 8 || n % 8 || r % 8) return static_cast<int>(cudaErrorInvalidValue);   // TMA rows
  return static_cast<int>(launch_wgmma_width(x, w, a, b, out, m, n, k, r, trans, scale, s));
}

extern "C" const char* repro_lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
