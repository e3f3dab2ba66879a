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
// ds) f32. xs, Bt and Ct are f32 or bf16 (one type); all arithmetic is f32.
//
// What bounds it: f32 operations. At mamba2-780m's prefill (nh 48, hd 64,
// ds 128, c 256) a 512-token layer does ~1.6 GFLOP (the c x c scores once
// per chunk, the intra, inter and state products per head) on ~13 MB of
// inputs and outputs: ~24 us on the 67 TFLOP/s f32 units against ~4 us of
// HBM traffic.
// Design:
//   * the TPU grid walks (batch, head block, chunk) with the chunk innermost
//     and carries h in VMEM scratch between grid steps, relying on the grid
//     running in order. CTAs run in no order, so one CTA owns one (batch,
//     head) and walks its chunks in a loop, h held in shared memory;
//   * each chunk is cut into 64-row tiles. For an output tile of rows i the
//     CTA loads C_i once (s-major in shared memory), adds the inter term
//     against h, then for each tile of rows j <= i builds the 64 x 64 scores
//     C_i B_j^T, masks j > i BEFORE taking exp (for j > i the exponent is
//     positive and could overflow), scales by the decay and multiplies into
//     dt_j x_j. Tiles of 64 rows bound shared memory to 142 KB at c = 256
//     and 164 KB at most (any c up to 2048, a multiple of nothing), opted in
//     above 48 KB with cudaFuncSetAttribute;
//   * 256 threads, each with a 4 x 4 register tile of every 64 x 64 product
//     (8 x 4 of the 128 x 64 state update), read from shared memory as float4;
//     plain f32 FMA: TF32 tensor cores would risk the 2e-3 tolerance;
//   * the decay cumsum is taken in double (a block scan per chunk): cum_i -
//     cum_j of two f32 sums near -3000 would lose ~1e-3 of relative accuracy
//     to cancellation; the difference is taken in double, then exp in f32.
// Known limits: one CTA per (batch, head) fills 48 of 132 SMs at batch 1;
// the c x c scores, shared by every head, are recomputed per head; no tensor
// cores. hd <= 64, ds <= 128, c <= 2048.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHD = 64;          // largest head dim (tiles are this wide)
constexpr int kDS = 128;         // largest state dim
constexpr int kT = 64;           // rows per i / j tile
constexpr int kLd = kT + 4;      // row stride of [k][64] tiles: 16-byte rows
constexpr int kLdS = kDS + 4;    // row stride of the [j][128] B tile
constexpr int kMaxChunk = 2048;

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

// cum[i] = sum_{r <= i} dts[r] * a over i < cpad, in double: a block scan in
// segments of kThreads (warp shuffles, then the warp totals).
__device__ void block_cumsum(const float* dts, double* cum, int cpad, float a, double* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < cpad; base += kThreads) {
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
      double w = lane < kWarps ? wsum[lane] : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < kWarps) wsum[lane] = w;
    }
    __syncthreads();
    if (i < cpad) cum[i] = v + carry + (warp > 0 ? wsum[warp - 1] : 0.0);
    carry += wsum[kWarps - 1];
    __syncthreads();  // wsum is rewritten by the next segment
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
    block_cumsum(dts, cum, cpad, a_h, wsum);
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
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nh, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bt), static_cast<const T*>(Ct), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), S, nh, hd, ds, c, cpad, xs_sb, xs_st,
      xs_sh, b_sb, b_st, c_sb, c_st);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of xs, Bt and Ct; dt, A, h0, y and hT are
// float32). h0 may be null (a zero initial state). Strides are in elements.
// Returns a cudaError_t (0 on success).
extern "C" int repro_ssd_scan(const void* xs, const void* dt, const void* A, const void* Bt,
                              const void* Ct, const void* h0, void* y, void* hT, int dtype,
                              int B, int S, int nh, int hd, int ds, int c, long long xs_sb,
                              long long xs_st, long long xs_sh, long long b_sb, long long b_st,
                              long long c_sb, long long c_st, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || nh <= 0 || hd <= 0 || hd > kHD || ds <= 0 ||
      ds > kDS || c <= 0 || c > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(xs, dt, A, Bt, Ct, h0, y, hT, B, S, nh, hd, ds, c,
                                          xs_sb, xs_st, xs_sh, b_sb, b_st, c_sb, c_st, s));
  if (dtype == 1)
    return static_cast<int>(launch<bf16>(xs, dt, A, Bt, Ct, h0, y, hT, B, S, nh, hd, ds, c,
                                         xs_sb, xs_st, xs_sh, b_sb, b_st, c_sb, c_st, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
