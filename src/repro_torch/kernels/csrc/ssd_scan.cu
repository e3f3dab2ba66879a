// Mamba2 SSD chunked scan (state-space duality), forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py::ssd_scan_chunked
// (body _kernel; wrapper ops.ssd_scan). It computes the same function as the
// reference's models/ssm.py::ssd_chunked: for each (batch, head) and each
// chunk of c rows, with la = dt * A and cum its inclusive cumsum over the
// chunk,
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//         + exp(cum_i) C_i . h                                    (inter)
//   h'    = exp(cum_end) h + sum_j exp(cum_end - cum_j) dt_j x_j B_j^T
// carrying h (hd x ds, f32) from chunk to chunk. Rows past the sequence end
// (the ragged last chunk) are read as zeros with dt = 0: no state update,
// decay 1, so hT is exact, as the reference's padding gives.
//
// Layout: xs (B, S, nh, hd) read through (batch, row, head) strides with a
// unit last stride, so a slice of the conv output needs no copy; dt (B, S, nh)
// f32; A (nh,) f32; Bt, Ct (B, S, ds) through (batch, row) strides; h0
// (B, nh, hd, ds) f32 or null (zeros). y (B, S, nh, hd) f32, hT (B, nh, hd,
// ds) f32. hd <= 64, ds <= 128, c <= 2048.
//
// Two routes; the wrapper (kernels/ssd_scan.py::_k3_path) picks one.
//
// The tensor-core route (repro_ssd_scan_tc): bf16 xs/Bt/Ct whose rows are
// 16-byte aligned. What bounds it: bytes. At mamba2-780m's prefill (B 1,
// S 512, nh 48, hd 64, ds 128, c 256) the call reads 3.4 MB of bf16 inputs
// and writes 6.3 MB of y and 1.6 MB of hT (f32): 0.0034 ms at 3.35 TB/s,
// against 0.0010 ms for its ~1 GFLOP at the bf16 tensor-core peak. Three
// kernels, launched one after the other on the caller's stream, with
// scratch the wrapper allocates:
//   1. chunk state (grid: chunk x 64-column half of ds, head, batch): the
//      decay cumsum per chunk, then the chunk's own state hc = X^T (w . B),
//      w_j = exp(cum_end - cum_j) dt_j, on tensor cores. Chunks are
//      independent, so they run in parallel instead of in a loop;
//   2. state passing (grid: tiles of hd*ds, head, batch): the only serial
//      part, h = exp(cum_end_k) h + hc_k, elementwise; the state entering
//      each chunk is written once, already split for pass 3's MMAs;
//   3. chunk scan (grid: 64-row i-tile x chunk x head x batch, the tiles
//      with the most j-tiles issued first): the scores C_i B_j^T, decayed,
//      masked and multiplied into X_j, and the inter term C_i h added from
//      the entering state.
// Against the FMA route's three limits: (a) one CTA per (batch, head)
// walking its chunks in order filled 48 of 132 SMs at batch 1; passes 1 and
// 3 have a CTA per chunk (and per row tile in 3), and only pass 2 is serial,
// over chunks, on elements. (b) The scores do not depend on the head, and
// a pass-3 CTA could share them over a block of heads; on the H100 blocks
// of 2 and 4 heads were slower than one head per CTA at every prefill
// shape measured (B 1 S 64/300/512, B 2 S 512: fewer CTAs cost more than
// the shared products save), so each CTA still computes its own head's
// scores, on tensor cores. (c) f32 FMA and scalar tile loads: every
// product is a bf16 mma.sync (m16n8k16, f32 accumulators), and tiles are
// staged by 16-byte cp.async copies, in a ring of 4 tiles in pass 1 and
// double-buffered in pass 3.
// Precision: C . B^T has two bf16 inputs, so its products are exact. Each
// other product has one f32 operand (the decayed scores times dt, w . B,
// the carried state h): it is split into bf16 hi + lo (hi = bf16(v), lo =
// bf16(v - hi), ~16 bits together) and multiplied by the exact bf16 input in
// two MMAs into one f32 accumulator. One bf16 rounding of that operand would
// miss 2e-3 by two orders of magnitude at full width; TF32 passes one call
// only by a thin margin. The decay cumsum is taken in double and kept as
// f32 hi + lo; cum_i - cum_j is (hi_i - hi_j) + (lo_i - lo_j), the double
// difference to within an f32 rounding, then expf; j > i is masked to -inf
// before exp. chip_smoke.py's `ssd_split_emulation` is this arithmetic in
// plain torch.
//
// The FMA route (repro_ssd_scan): f32 inputs, or bf16 rows that cp.async
// cannot copy. One CTA of 256 threads per (batch, head) walks the chunks in
// order with h in shared memory (the TPU grid's order: it carried h in VMEM
// between grid steps); 64-row tiles, each product in f32 FMA on a 4 x 4
// register tile; the same cumsum, mask and decay rules.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHD = 64;          // largest head dim (tiles are this wide)
constexpr int kDS = 128;         // largest state dim
constexpr int kT = 64;           // rows per i / j tile
constexpr int kMaxChunk = 2048;

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

// cum[i] = sum_{r <= i} dts[r] * a over i < cpad, in double: a block scan of
// NT threads in segments of NT (warp shuffles, then the warp totals).
template <int NT>
__device__ void block_cumsum(const float* dts, double* cum, int cpad, float a, double* wsum) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < cpad; base += NT) {
    const int i = base + tid;
    double v = i < cpad ? static_cast<double>(dts[i] * a) : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double w = lane < NW ? wsum[lane] : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < NW) wsum[lane] = w;
    }
    __syncthreads();
    if (i < cpad) cum[i] = v + carry + (warp > 0 ? wsum[warp - 1] : 0.0);
    carry += wsum[NW - 1];
    __syncthreads();  // wsum is rewritten by the next segment
  }
}

// ============================================================ FMA route ====

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLd = kT + 4;      // row stride of [k][64] tiles: 16-byte rows
constexpr int kLdS = kDS + 4;    // row stride of the [j][128] B tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// dst[s][r] = src[(row0 + r) * row_stride + s] for r < nrows, s < ds; zeros
// elsewhere in the 128 x 64 tile (s-major, row stride kLd).
template <typename T>
__device__ void load_smajor(float* dst, const T* src, int64_t row_stride, int row0, int nrows,
                            int ds) {
  for (int idx = threadIdx.x; idx < kT * kDS; idx += kThreads) {
    const int r = idx / kDS, s = idx % kDS;
    float v = 0.f;
    if (r < nrows && s < ds) v = to_f(src[static_cast<int64_t>(row0 + r) * row_stride + s]);
    dst[s * kLd + r] = v;
  }
}

size_t smem_bytes(int cpad) {
  return sizeof(float) * (3 * kDS * kLd + 2 * kT * kLd + cpad) + sizeof(double) * (cpad + kWarps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ xs, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bt,
                    const T* __restrict__ Ct, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ hT, int S, int nh, int hd, int ds,
                    int c, int cpad, int64_t xs_sb, int64_t xs_st, int64_t xs_sh, int64_t b_sb,
                    int64_t b_st, int64_t c_sb, int64_t c_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // state, s-major: hs[s][p]
  float* cs = hs + kDS * kLd;                       // C tile, s-major: cs[s][i]
  float* bs = cs + kDS * kLd;  // B tile: bs[s][j] (outputs), bs[j][s] (state update)
  float* gs = bs + kDS * kLd;  // masked, decayed scores: gs[j][i]
  float* us = gs + kT * kLd;   // dt_j x_j (times the end decay in the update): us[j][p]
  double* cum = reinterpret_cast<double*>(us + kT * kLd);
  double* wsum = cum + cpad;
  float* dts = reinterpret_cast<float*>(wsum + kWarps);

  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a_h = A[head];
  const T* xb = xs + b * xs_sb + head * xs_sh;
  const T* bb = Bt + b * b_sb;
  const T* cb = Ct + b * c_sb;
  const float* dtb = dt + static_cast<int64_t>(b) * S * nh + head;
  const int64_t y_row = static_cast<int64_t>(nh) * hd;
  float* yb = y + (static_cast<int64_t>(b) * S * nh + head) * hd;
  const int64_t h_off = (static_cast<int64_t>(b) * nh + head) * hd * ds;

  for (int idx = tid; idx < kHD * kDS; idx += kThreads) {
    const int p = idx / kDS, s = idx % kDS;
    float v = 0.f;
    if (h0 != nullptr && p < hd && s < ds) v = h0[h_off + static_cast<int64_t>(p) * ds + s];
    hs[s * kLd + p] = v;
  }

  const int n_chunks = (S + c - 1) / c;
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * c;
    const int L = min(c, S - t0);  // rows of this chunk inside the sequence
    __syncthreads();               // the last chunk's update is done with dts, hs
    for (int i = tid; i < cpad; i += kThreads)
      dts[i] = i < L ? dtb[static_cast<int64_t>(t0 + i) * nh] : 0.f;
    __syncthreads();
    block_cumsum<kThreads>(dts, cum, cpad, a_h, wsum);
    const double cum_end = cum[c - 1];  // rows L.. add 0: the reference's padding

    // ---------------------------------------------------------- outputs --
    for (int i0 = 0; i0 < L; i0 += kT) {
      load_smajor(cs, cb, c_st, t0 + i0, min(kT, L - i0), ds);
      __syncthreads();
      float acc[4][4] = {};
      for (int s = 0; s < kDS; ++s) outer4(acc, ld4(&cs[s * kLd + ty * 4]), ld4(&hs[s * kLd + tx * 4]));
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float e = expf(static_cast<float>(cum[i0 + ty * 4 + ii]));
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[ii][pp] *= e;
      }
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        const int jn = min(kT, L - j0);
        load_smajor(bs, bb, b_st, t0 + j0, jn, ds);
        for (int idx = tid; idx < kT * kHD; idx += kThreads) {
          const int j = idx / kHD, p = idx % kHD;
          float v = 0.f;
          if (j < jn && p < hd) v = dts[j0 + j] * to_f(xb[static_cast<int64_t>(t0 + j0 + j) * xs_st + p]);
          us[j * kLd + p] = v;
        }
        __syncthreads();
        float g[4][4] = {};
        for (int s = 0; s < kDS; ++s) outer4(g, ld4(&cs[s * kLd + ty * 4]), ld4(&bs[s * kLd + tx * 4]));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + tx * 4 + jj;
          float col[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int i = i0 + ty * 4 + ii;
            // mask before exp: for j > i the exponent is positive
            col[ii] = j <= i ? g[ii][jj] * expf(static_cast<float>(cum[i] - cum[j])) : 0.f;
          }
          *reinterpret_cast<float4*>(&gs[(tx * 4 + jj) * kLd + ty * 4]) =
              make_float4(col[0], col[1], col[2], col[3]);
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) outer4(acc, ld4(&gs[j * kLd + ty * 4]), ld4(&us[j * kLd + tx * 4]));
        __syncthreads();  // the next j tile overwrites bs, us and gs
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = i0 + ty * 4 + ii;
        if (r >= L) continue;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const int p = tx * 4 + pp;
          if (p < hd) yb[static_cast<int64_t>(t0 + r) * y_row + p] = acc[ii][pp];
        }
      }
    }

    // ----------------------------------------------------- state update --
    float hacc[8][4];
    const float a_chunk = expf(static_cast<float>(cum_end));
#pragma unroll
    for (int ss = 0; ss < 8; ++ss)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) hacc[ss][pp] = a_chunk * hs[(ty * 8 + ss) * kLd + tx * 4 + pp];
    for (int j0 = 0; j0 < L; j0 += kT) {
      const int jn = min(kT, L - j0);
      __syncthreads();  // earlier readers of bs and us are done
      for (int idx = tid; idx < kT * kDS; idx += kThreads) {
        const int j = idx / kDS, s = idx % kDS;
        float v = 0.f;
        if (j < jn && s < ds) v = to_f(bb[static_cast<int64_t>(t0 + j0 + j) * b_st + s]);
        bs[j * kLdS + s] = v;
      }
      for (int idx = tid; idx < kT * kHD; idx += kThreads) {
        const int j = idx / kHD, p = idx % kHD;
        float v = 0.f;
        if (j < jn && p < hd)
          v = expf(static_cast<float>(cum_end - cum[j0 + j])) * dts[j0 + j] *
              to_f(xb[static_cast<int64_t>(t0 + j0 + j) * xs_st + p]);
        us[j * kLd + p] = v;
      }
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        const float4 b0 = ld4(&bs[j * kLdS + ty * 8]);
        const float4 b1 = ld4(&bs[j * kLdS + ty * 8 + 4]);
        const float4 u = ld4(&us[j * kLd + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int ss = 0; ss < 8; ++ss)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) hacc[ss][pp] = fmaf(bv[ss], uv[pp], hacc[ss][pp]);
      }
    }
    __syncthreads();  // every thread is done reading hs for this chunk
#pragma unroll
    for (int ss = 0; ss < 8; ++ss)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) hs[(ty * 8 + ss) * kLd + tx * 4 + pp] = hacc[ss][pp];
  }
  __syncthreads();
  for (int idx = tid; idx < kHD * kDS; idx += kThreads) {
    const int p = idx / kDS, s = idx % kDS;
    if (p < hd && s < ds) hT[h_off + static_cast<int64_t>(p) * ds + s] = hs[s * kLd + p];
  }
}

template <typename T>
cudaError_t launch(const void* xs, const void* dt, const void* A, const void* Bt, const void* Ct,
                   const void* h0, void* y, void* hT, int B, int S, int nh, int hd, int ds, int c,
                   long long xs_sb, long long xs_st, long long xs_sh, long long b_sb,
                   long long b_st, long long c_sb, long long c_st, cudaStream_t stream) {
  const int cpad = (c + kT - 1) / kT * kT;
  const size_t smem = smem_bytes(cpad);
  static int granted[kMaxDevices] = {};  // one per T
  cudaError_t err =
      opt_in_smem(reinterpret_cast<const void*>(ssd_scan_kernel<T>), smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bt), static_cast<const T*>(Ct), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), S, nh, hd, ds, c, cpad, xs_sb, xs_st,
      xs_sh, b_sb, b_st, c_sb, c_st);
  return cudaGetLastError();
}

// ==================================================== tensor-core route ====

constexpr int kTC = 128;         // threads of passes 1 and 3: 4 warps of 16 rows each
constexpr int kLdX = kHD + 8;    // bf16 row stride of [64][64] tiles, and
constexpr int kLdC = kDS + 8;    // of [64][128] tiles: rows 16 B apart mod 128 B,
                                 // so ldmatrix's 8 row reads hit distinct banks
constexpr int kPassThreads = 256;  // threads of pass 2
constexpr int kHTile = kHD * kDS;  // elements of one padded state tile
constexpr int kStages = 4;         // pass 1's ring of j-tiles in flight

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (bytes 0: 16 zero bytes, `src` not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8q..8q+7 give the row
// addresses of matrix q. `_t` transposes each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

// (v0, v1) as bf16 pairs hi = bf16(v), lo = bf16(v - hi); v0 in the low half.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Rows [0, nrows) of a bf16 tile at `src` (row stride in elements), their
// first `ncols` columns, into dst [64][LD] by cp.async; everything else of
// the 64 x COLS tile zero-filled. `any` is a valid address for the copies
// that read nothing. Rows are 16-byte aligned (the wrapper's route check).
template <int COLS, int LD>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int64_t stride, int nrows,
                                           int ncols, const void* any) {
  constexpr int kChunks = COLS / 8;
  for (int idx = threadIdx.x; idx < kT * kChunks; idx += kTC) {
    const int r = idx / kChunks, c8 = idx % kChunks;
    const int n = r < nrows ? min(max(ncols - c8 * 8, 0), 8) : 0;
    cp_async16(dst + r * LD + c8 * 8, n ? static_cast<const void*>(src + r * stride + c8 * 8) : any,
               2 * n);
  }
}

// The scratch of one call, carved from one buffer (each part 256-byte
// aligned): hc (B, n, nh, hd, ds) f32, each chunk's own state; hsplit (B, n,
// nh, 2, 64, 128) bf16, the state entering each chunk as hi and lo, zero-
// padded to the tile; cum (B, n, nh, cpad) float2, the decay cumsum as f32
// hi + lo; dtc (B, n, nh, cpad) f32, dt by chunk; decay (B, n, nh) f32.
struct Scratch {
  float* hc;
  bf16* hsplit;
  float2* cum;
  float* dtc;
  float* decay;
};

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

size_t carve(char* base, long long B, long long n, long long nh, int hd, int ds, int cpad,
             Scratch* out) {
  const long long bkh = B * n * nh;
  const size_t sizes[5] = {sizeof(float) * bkh * hd * ds, sizeof(bf16) * bkh * 2 * kHTile,
                           sizeof(float2) * bkh * cpad, sizeof(float) * bkh * cpad,
                           sizeof(float) * bkh};
  size_t off[5], total = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = total;
    total += align256(sizes[i]);
  }
  if (out != nullptr) {
    out->hc = reinterpret_cast<float*>(base + off[0]);
    out->hsplit = reinterpret_cast<bf16*>(base + off[1]);
    out->cum = reinterpret_cast<float2*>(base + off[2]);
    out->dtc = reinterpret_cast<float*>(base + off[3]);
    out->decay = reinterpret_cast<float*>(base + off[4]);
  }
  return total;
}

size_t state_smem_bytes(int cpad) {
  return sizeof(bf16) * (2 * kStages + 2) * kT * kLdX + sizeof(double) * (cpad + kTC / 32) +
         sizeof(float) * 2 * cpad;
}

// Pass 1 (grid: chunk x 64-column half of ds, head, batch). The chunk's
// decay cumsum in double; cum (as f32 hi + lo), dt and the chunk decay
// exp(cum_end) go to scratch for passes 2 and 3 (from the first ds half).
// Then the chunk's own state
//   hc[p][s] = sum_j X[j][p] (w_j B[j][s]),  w_j = exp(cum_end - cum_j) dt_j,
// with X^T the exact bf16 input and w . B (f32) split into bf16 hi + lo: two
// MMAs into one f32 accumulator. Warp w owns rows p in [16w, 16w + 16), the
// CTA 64 columns s. X and B tiles of 64 rows j go through a ring of
// kStages, the first ones in flight during the cumsum.
__global__ void __launch_bounds__(kTC)
    ssd_chunk_state_kernel(const bf16* __restrict__ xs, const float* __restrict__ dt,
                           const float* __restrict__ A, const bf16* __restrict__ Bt, Scratch sc,
                           int S, int nh, int hd, int ds, int c, int cpad, int n_chunks,
                           int64_t xs_sb, int64_t xs_st, int64_t xs_sh, int64_t b_sb,
                           int64_t b_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stg = reinterpret_cast<bf16*>(smem_raw);  // kStages of X [j][p], B [j][s]
  bf16* whi = stg + 2 * kStages * kT * kLdX;      // (w . B) hi [j][s]
  bf16* wlo = whi + kT * kLdX;                    // (w . B) lo [j][s]
  double* cum = reinterpret_cast<double*>(wlo + kT * kLdX);
  double* wsum = cum + cpad;
  float* dts = reinterpret_cast<float*>(wsum + kTC / 32);
  float* w = dts + cpad;

  const int nhalf = (ds + kT - 1) / kT;
  const int k = blockIdx.x / nhalf, s0 = (blockIdx.x % nhalf) * kT;
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int t0 = k * c, L = min(c, S - t0);
  const bf16* xb = xs + b * xs_sb + t0 * xs_st + head * xs_sh;
  const bf16* bb = Bt + b * b_sb + t0 * b_st + s0;
  const int ntiles = (L + kT - 1) / kT;

  // one commit group per tile, empty past the last, so that the group of
  // tile jt is always kStages - 1 groups older than the newest at its wait
  auto load_stage = [&](int jt) {
    if (jt < ntiles) {
      bf16* st = stg + (jt % kStages) * 2 * kT * kLdX;
      const int j0 = jt * kT, jn = min(kT, L - j0);
      tile_async<kHD, kLdX>(st, xb + j0 * xs_st, xs_st, jn, hd, xs);
      tile_async<kT, kLdX>(st + kT * kLdX, bb + j0 * b_st, b_st, jn, ds - s0, xs);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int jt = 0; jt < kStages; ++jt) load_stage(jt);

  for (int i = tid; i < cpad; i += kTC)
    dts[i] = i < L ? dt[(static_cast<int64_t>(b) * S + t0 + i) * nh + head] : 0.f;
  __syncthreads();
  block_cumsum<kTC>(dts, cum, cpad, A[head], wsum);
  const double cum_end = cum[c - 1];  // rows L.. add 0: the reference's padding
  const int64_t bkh = (static_cast<int64_t>(b) * n_chunks + k) * nh + head;
  for (int i = tid; i < cpad; i += kTC) {
    w[i] = expf(static_cast<float>(cum_end - cum[i])) * dts[i];
    if (s0 == 0) {
      const float hi = static_cast<float>(cum[i]);
      sc.cum[bkh * cpad + i] = make_float2(hi, static_cast<float>(cum[i] - hi));
      sc.dtc[bkh * cpad + i] = dts[i];
    }
  }
  if (s0 == 0 && tid == 0) sc.decay[bkh] = expf(static_cast<float>(cum_end));

  float acc[8][4] = {};
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kT;
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this stage has landed (and, the first time, w is complete)
    const bf16* xt = stg + (jt % kStages) * 2 * kT * kLdX;
    const bf16* bt = xt + kT * kLdX;
    for (int idx = tid; idx < kT * 8; idx += kTC) {
      const int r = idx >> 3, c8 = (idx & 7) * 8;
      const uint4 u = *reinterpret_cast<const uint4*>(bt + r * kLdX + c8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float wj = w[j0 + r];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        split2(wj * f.x, wj * f.y, hi[e], lo[e]);
      }
      *reinterpret_cast<uint4*>(whi + r * kLdX + c8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(wlo + r * kLdX + c8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {  // k = j
      uint32_t a[4];                         // A[p][j] = X[j][p]
      ldsm_x4_t(a, xt + (ks * 16 + r8 + (q >> 1) * 8) * kLdX + warp * 16 + (q & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // n = s, two 8-column tiles
        uint32_t bh[4], bl[4];
        const int off = (ks * 16 + r8 + (q & 1) * 8) * kLdX + np * 16 + (q >> 1) * 8;
        ldsm_x4_t(bh, whi + off);
        ldsm_x4_t(bl, wlo + off);
        mma16816(acc[2 * np], a, bh[0], bh[1]);
        mma16816(acc[2 * np], a, bl[0], bl[1]);
        mma16816(acc[2 * np + 1], a, bh[2], bh[3]);
        mma16816(acc[2 * np + 1], a, bl[2], bl[3]);
      }
    }
    __syncthreads();  // this stage and whi/wlo are free
    load_stage(jt + kStages);
  }

  float* out = sc.hc + bkh * hd * ds;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int s = s0 + nt * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = warp * 16 + g + half * 8;
      if (p >= hd) continue;
      if (s < ds) out[p * ds + s] = acc[nt][2 * half];
      if (s + 1 < ds) out[p * ds + s + 1] = acc[nt][2 * half + 1];
    }
  }
}

// Pass 2 (grid: tiles of the padded 64 x 128 state, head, batch): the
// recurrence between chunks, elementwise, h = exp(cum_end_k) h + hc_k from
// h0 (or zeros). The state entering chunk k goes to hsplit as bf16 hi + lo
// (zeros in the padding), which pass 3 copies as it is; the state after the
// last chunk is hT.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(Scratch sc, const float* __restrict__ h0, float* __restrict__ hT,
                          int nh, int hd, int ds, int n_chunks) {
  const int idx = blockIdx.x * kPassThreads + threadIdx.x;  // < kHTile
  const int head = blockIdx.y, b = blockIdx.z;
  const int p = idx / kDS, s = idx % kDS;
  const bool valid = p < hd && s < ds;
  const int hdds = hd * ds, e = p * ds + s;
  const int64_t bh = static_cast<int64_t>(b) * nh + head;
  const int64_t first = static_cast<int64_t>(b) * n_chunks * nh + head;  // (b, chunk 0, head)
  const float* src = sc.hc + first * hdds + e;
  bf16* dst = sc.hsplit + first * 2 * kHTile + idx;
  const float* a = sc.decay + first;
  const int64_t step = static_cast<int64_t>(nh) * hdds, dstep = static_cast<int64_t>(nh) * 2 * kHTile;
  float h = valid && h0 != nullptr ? h0[bh * hdds + e] : 0.f;
  float next = valid ? src[0] : 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const float local = next;
    if (valid && k + 1 < n_chunks) next = src[(k + 1) * step];  // read ahead of the update
    const bf16 hi = __float2bfloat16_rn(h);
    dst[k * dstep] = hi;
    dst[k * dstep + kHTile] = __float2bfloat16_rn(h - __bfloat162float(hi));
    h = fmaf(a[k * nh], h, local);
  }
  if (valid) hT[bh * hdds + e] = h;
}

// bf16 elements of one pass-3 buffer: a j stage (B_j, then X_j) or the
// split entering state (hi, lo), whichever is larger
constexpr int kScanStage = kT * kLdC + kT * kLdX;
constexpr int kScanBuf = kScanStage > 2 * kHD * kLdC ? kScanStage : 2 * kHD * kLdC;

size_t scan_smem_bytes(int cpad) {
  return sizeof(bf16) * (kT * kLdC + 2 * kScanBuf) + (sizeof(float2) + sizeof(float)) * cpad;
}

// Pass 3 (grid: one dimension over i-tile x chunk x head x batch, the last
// i-tiles, which have the most j-tiles below the diagonal, first). For the
// 64 rows i of its tile: for each j-tile <= i the scores C_i B_j^T (exact:
// two bf16 inputs), G_ij = S_ij exp(cum_i - cum_j) dt_j (masked to -inf
// before exp for j > i) as hi + lo, acc += G_hi X_j + G_lo X_j; the
// scores' accumulator fragments become the A fragments of G in registers.
// Then the inter term acc += exp(cum_i) (C_i h_hi + C_i h_lo) from the
// split entering state (skipped where it is zero). cum_i - cum_j is taken
// from f32 hi + lo parts (exact to an f32 rounding of the difference: no
// f64 per element). Two buffers rotate: the j-tiles, then the entering
// state, each copied while the one before is multiplied.
__global__ void __launch_bounds__(kTC)
    ssd_chunk_scan_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ Bt,
                          const bf16* __restrict__ Ct, Scratch sc, float* __restrict__ y, int B,
                          int S, int nh, int hd, int ds, int c, int cpad, int n_chunks,
                          int has_h0, int64_t xs_sb, int64_t xs_st, int64_t xs_sh,
                          int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // C_i [i][s]
  bf16* const buf0 = cs + kT * kLdC;
  bf16* const buf1 = buf0 + kScanBuf;
  auto buf = [&](int i) { return (i & 1) ? buf1 : buf0; };
  float2* cums = reinterpret_cast<float2*>(buf1 + kScanBuf);  // [cpad]
  float* dts = reinterpret_cast<float*>(cums + cpad);          // [cpad]

  const int n_it = cpad / kT;
  const int per_it = n_chunks * nh * B;
  int lin = blockIdx.x;
  const int it = n_it - 1 - lin / per_it;
  lin %= per_it;
  const int head = lin % nh;
  lin /= nh;
  const int k = lin % n_chunks, b = lin / n_chunks;
  const int t0 = k * c, L = min(c, S - t0), i0 = it * kT;
  if (i0 >= L) return;  // a tile past the end of the ragged last chunk
  const bool has_state = k > 0 || has_h0;  // the state entering chunk 0 without h0 is zero
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, q = lane >> 3, r8 = lane & 7;
  const bf16* xb = xs + b * xs_sb + t0 * xs_st + head * xs_sh;
  const bf16* bb = Bt + b * b_sb + t0 * b_st;
  const bf16* cb = Ct + b * c_sb + t0 * c_st;
  const int64_t bkh = (static_cast<int64_t>(b) * n_chunks + k) * nh + head;

  auto load_stage = [&](bf16* st, int j0) {
    const int jn = min(kT, L - j0);
    tile_async<kDS, kLdC>(st, bb + j0 * b_st, b_st, jn, ds, xs);
    tile_async<kHD, kLdX>(st + kT * kLdC, xb + j0 * xs_st, xs_st, jn, hd, xs);
    cp_async_commit();
  };
  // C_i with the first j-tile in one commit group, then cum and dt of rows
  // [0, nrow) (from pass 1) in the next
  tile_async<kDS, kLdC>(cs, cb + i0 * c_st, c_st, min(kT, L - i0), ds, xs);
  load_stage(buf(0), 0);
  const int nrow = i0 + kT;
  for (int e = tid; e < nrow / 2 + nrow / 4; e += kTC) {
    if (e < nrow / 2)
      cp_async16(cums + 2 * e, sc.cum + bkh * cpad + 2 * e, 16);
    else
      cp_async16(dts + 4 * (e - nrow / 2), sc.dtc + bkh * cpad + 4 * (e - nrow / 2), 16);
  }
  cp_async_commit();

  const int row0 = warp * 16 + g;  // this thread's rows of the tile: row0, row0 + 8
  const int ia = i0 + row0, ib = ia + 8;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    // the other buffer was last read in iteration jt - 1
    if (jt < it) {
      load_stage(buf((jt + 1) & 1), j0 + kT);
      cp_async_wait<1>();
    } else if (has_state) {  // the split entering state, hi then lo, [p][s]
      const bf16* src = sc.hsplit + bkh * 2 * kHTile;
      bf16* dst = buf((jt + 1) & 1);
      for (int idx = tid; idx < 2 * kHD * (kDS / 8); idx += kTC) {
        const int r = idx / (kDS / 8), c8 = (idx % (kDS / 8)) * 8;
        cp_async16(dst + r * kLdC + c8, src + r * kDS + c8, 16);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* bs = buf(jt & 1);
    const bf16* xst = bs + kT * kLdC;

    float sc4[8][4];  // scores S[i][j] of this warp's 16 rows, 64 columns j
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc4[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDS / 16; ++ks) {  // k = s
      uint32_t a[4];
      ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * kLdC + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // n = j; B[s][j] = Bt[j][s]
        uint32_t bf[4];
        ldsm_x4(bf, bs + (np * 16 + r8 + (q >> 1) * 8) * kLdC + ks * 16 + (q & 1) * 8);
        mma16816(sc4[2 * np], a, bf[0], bf[1]);
        mma16816(sc4[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    const float2 ca = cums[ia], cb2 = cums[ib];
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {  // k = j
      uint32_t ahi[4], alo[4];  // a0..a3: (row g, k 0-7), (g+8, 0-7), (g, 8-15), (g+8, 8-15)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * ks + half, j = j0 + nt * 8 + 2 * tq;
        const float4 cj = *reinterpret_cast<const float4*>(cums + j);  // cum_j, cum_j+1
        const float2 dj = *reinterpret_cast<const float2*>(dts + j);
        // cum_i - cum_j from the hi and lo parts; masked before exp: for
        // j > i the exponent is positive
        const float xa0 = (ca.x - cj.x) + (ca.y - cj.y), xa1 = (ca.x - cj.z) + (ca.y - cj.w);
        const float xb0 = (cb2.x - cj.x) + (cb2.y - cj.y), xb1 = (cb2.x - cj.z) + (cb2.y - cj.w);
        const float ga0 = sc4[nt][0] * expf(j <= ia ? xa0 : -INFINITY) * dj.x;
        const float ga1 = sc4[nt][1] * expf(j + 1 <= ia ? xa1 : -INFINITY) * dj.y;
        const float gb0 = sc4[nt][2] * expf(j <= ib ? xb0 : -INFINITY) * dj.x;
        const float gb1 = sc4[nt][3] * expf(j + 1 <= ib ? xb1 : -INFINITY) * dj.y;
        split2(ga0, ga1, ahi[2 * half], alo[2 * half]);
        split2(gb0, gb1, ahi[2 * half + 1], alo[2 * half + 1]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // n = p; B[j][p] = X[j][p]
        uint32_t bx[4];
        ldsm_x4_t(bx, xst + (ks * 16 + r8 + (q & 1) * 8) * kLdX + np * 16 + (q >> 1) * 8);
        mma16816(acc[2 * np], ahi, bx[0], bx[1]);
        mma16816(acc[2 * np], alo, bx[0], bx[1]);
        mma16816(acc[2 * np + 1], ahi, bx[2], bx[3]);
        mma16816(acc[2 * np + 1], alo, bx[2], bx[3]);
      }
    }
    __syncthreads();  // the next copies overwrite this buffer
  }

  if (has_state) {
    const bf16* hhi = buf((it + 1) & 1);
    const bf16* hlo = hhi + kHD * kLdC;
    cp_async_wait<0>();
    __syncthreads();
    float t[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDS / 16; ++ks) {  // k = s
      uint32_t a[4];
      ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * kLdC + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // n = p; B[s][p] = h[p][s]
        uint32_t bh[4], bl[4];
        const int off = (np * 16 + r8 + (q >> 1) * 8) * kLdC + ks * 16 + (q & 1) * 8;
        ldsm_x4(bh, hhi + off);
        ldsm_x4(bl, hlo + off);
        mma16816(t[2 * np], a, bh[0], bh[1]);
        mma16816(t[2 * np], a, bl[0], bl[1]);
        mma16816(t[2 * np + 1], a, bh[2], bh[3]);
        mma16816(t[2 * np + 1], a, bl[2], bl[3]);
      }
    }
    const float2 ca = cums[ia], cb2 = cums[ib];
    const float ea = expf(ca.x + ca.y), eb = expf(cb2.x + cb2.y);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] += t[nt][0] * ea;
      acc[nt][1] += t[nt][1] * ea;
      acc[nt][2] += t[nt][2] * eb;
      acc[nt][3] += t[nt][3] * eb;
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? ib : ia;
    if (r >= L) continue;
    float* yr = y + ((static_cast<int64_t>(b) * S + t0 + r) * nh + head) * hd;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = nt * 8 + 2 * tq;
      if (p + 1 < hd && !(hd & 1))
        *reinterpret_cast<float2*>(yr + p) = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      else {
        if (p < hd) yr[p] = acc[nt][2 * half];
        if (p + 1 < hd) yr[p + 1] = acc[nt][2 * half + 1];
      }
    }
  }
}

// The shapes both routes take.
bool shape_ok(int B, int S, int nh, int hd, int ds, int c) {
  return B > 0 && B <= 65535 && S > 0 && nh > 0 && nh <= 65535 && hd > 0 && hd <= kHD && ds > 0 &&
         ds <= kDS && c > 0 && c <= kMaxChunk;
}

}  // namespace

// The FMA route. dtype: 0 = float32, 1 = bfloat16 (of xs, Bt and Ct; dt, A,
// h0, y and hT are float32). h0 may be null (a zero initial state). Strides
// are in elements. Returns a cudaError_t (0 on success).
extern "C" int repro_ssd_scan(const void* xs, const void* dt, const void* A, const void* Bt,
                              const void* Ct, const void* h0, void* y, void* hT, int dtype,
                              int B, int S, int nh, int hd, int ds, int c, long long xs_sb,
                              long long xs_st, long long xs_sh, long long b_sb, long long b_st,
                              long long c_sb, long long c_st, void* stream) {
  if (!shape_ok(B, S, nh, hd, ds, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(xs, dt, A, Bt, Ct, h0, y, hT, B, S, nh, hd, ds, c,
                                          xs_sb, xs_st, xs_sh, b_sb, b_st, c_sb, c_st, s));
  if (dtype == 1)
    return static_cast<int>(launch<bf16>(xs, dt, A, Bt, Ct, h0, y, hT, B, S, nh, hd, ds, c,
                                         xs_sb, xs_st, xs_sh, b_sb, b_st, c_sb, c_st, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of scratch the tensor-core route needs for this shape (0 for a shape
// it does not take); the caller allocates them and passes them as `scratch`.
extern "C" long long repro_ssd_scan_tc_scratch_bytes(int B, int S, int nh, int hd, int ds,
                                                     int c) {
  if (!shape_ok(B, S, nh, hd, ds, c)) return 0;
  const int n_chunks = (S + c - 1) / c, cpad = (c + kT - 1) / kT * kT;
  return static_cast<long long>(carve(nullptr, B, n_chunks, nh, hd, ds, cpad, nullptr));
}

// The tensor-core route: bf16 xs, Bt and Ct with 16-byte aligned rows (base
// addresses and strides), the rest as repro_ssd_scan; `scratch` holds
// repro_ssd_scan_tc_scratch_bytes bytes, 256-byte aligned. Three launches
// on `stream`; returns a cudaError_t.
extern "C" int repro_ssd_scan_tc(const void* xs, const void* dt, const void* A, const void* Bt,
                                 const void* Ct, const void* h0, void* y, void* hT,
                                 void* scratch, int B, int S, int nh, int hd, int ds, int c,
                                 long long xs_sb, long long xs_st, long long xs_sh,
                                 long long b_sb, long long b_st, long long c_sb, long long c_st,
                                 void* stream) {
  if (!shape_ok(B, S, nh, hd, ds, c)) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(Bt) |
                          reinterpret_cast<uintptr_t>(Ct);
  if ((addrs & 15) || (reinterpret_cast<uintptr_t>(scratch) & 255) ||
      ((xs_sb | xs_st | xs_sh | b_sb | b_st | c_sb | c_st) & 7))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (S + c - 1) / c, cpad = (c + kT - 1) / kT * kT;
  const long long scan_ctas = static_cast<long long>(cpad / kT) * n_chunks * nh * B;
  if (scan_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Scratch sc;
  carve(static_cast<char*>(scratch), B, n_chunks, nh, hd, ds, cpad, &sc);
  const bf16* x = static_cast<const bf16*>(xs);
  const bf16* bt = static_cast<const bf16*>(Bt);
  const bf16* ct = static_cast<const bf16*>(Ct);

  const size_t smem1 = state_smem_bytes(cpad);
  static int granted1[kMaxDevices] = {}, granted3[kMaxDevices] = {};
  cudaError_t err =
      opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_state_kernel), smem1, granted1);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<<<dim3(n_chunks * ((ds + kT - 1) / kT), nh, B), kTC, smem1, s>>>(
      x, static_cast<const float*>(dt), static_cast<const float*>(A), bt, sc, S, nh, hd, ds, c,
      cpad, n_chunks, xs_sb, xs_st, xs_sh, b_sb, b_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ssd_state_pass_kernel<<<dim3(kHTile / kPassThreads, nh, B), kPassThreads, 0, s>>>(
      sc, static_cast<const float*>(h0), static_cast<float*>(hT), nh, hd, ds, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t smem3 = scan_smem_bytes(cpad);
  err = opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_scan_kernel), smem3, granted3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<<<dim3(static_cast<unsigned>(scan_ctas)), kTC, smem3, s>>>(
      x, bt, ct, sc, static_cast<float*>(y), B, S, nh, hd, ds, c, cpad, n_chunks, h0 != nullptr,
      xs_sb, xs_st, xs_sh, b_sb, b_st, c_sb, c_st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
