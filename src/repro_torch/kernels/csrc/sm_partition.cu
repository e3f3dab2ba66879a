// SM partitions (green contexts) and the SM-id probe, for Hopper (sm_90a).
//
// Not a port of a TPU kernel. The reference runs a co-located round as one
// XLA program whose scheduler interleaves decode's memory streaming with
// the finetune units' matmuls (repro/core/colocation.py, "the TPU analogue
// of GreenContext SM partitioning"). On the card the port runs decode and
// the units at once on two disjoint sets of SMs, each a green context with
// a stream of its own (core/partition.py):
//   * repro_sm_split makes both partitions from ONE split of the device's
//     SM resource (cuDevSmResourceSplitByCount: a group of at least
//     `first_sms` SMs and the remainder), so the two sets are disjoint by
//     construction; each becomes a green context (cuGreenCtxCreate) with a
//     non-blocking stream (cuGreenCtxStreamCreate). Work put on a stream
//     runs on its context's SMs only.
//   * repro_smid_probe writes each CTA's %smid; a CTA holds more than half
//     an SM's shared memory, so no two share an SM, and spins long enough
//     for the launch to spread over every SM it may use. core/partition.py
//     holds the ids a replayed graph writes against its partition's set.
// The driver's green-context API lives in libcuda, not in the runtime: it
// is looked up through the runtime's entry-point query (as lora_matmul.cu
// looks up cuTensorMapEncodeTiled), so the library needs no -lcuda.
// Driver calls return a CUresult, the probe a cudaError_t; each has its own
// error-string function.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The driver's function of this name, at the ABI of the toolkit built
// against (cuGreenCtxStreamCreate exists since 12.5), or null.
void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, CUDART_VERSION, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

typedef CUresult (*DeviceGetFn)(CUdevice*, int);
typedef CUresult (*GetDevResourceFn)(CUdevice, CUdevResource*, CUdevResourceType);
typedef CUresult (*SplitByCountFn)(CUdevResource*, unsigned int*, const CUdevResource*,
                                   CUdevResource*, unsigned int, unsigned int);
typedef CUresult (*GenerateDescFn)(CUdevResourceDesc*, CUdevResource*, unsigned int);
typedef CUresult (*GreenCtxCreateFn)(CUgreenCtx*, CUdevResourceDesc, CUdevice, unsigned int);
typedef CUresult (*GreenCtxStreamCreateFn)(CUstream*, CUgreenCtx, unsigned int, int);
typedef CUresult (*GreenCtxDestroyFn)(CUgreenCtx);
typedef CUresult (*StreamDestroyFn)(CUstream);
typedef CUresult (*GetErrorStringFn)(CUresult, const char**);

struct Driver {
  DeviceGetFn device_get;
  GetDevResourceFn get_resource;
  SplitByCountFn split;
  GenerateDescFn desc;
  GreenCtxCreateFn ctx_create;
  GreenCtxStreamCreateFn stream_create;
  GreenCtxDestroyFn ctx_destroy;
  StreamDestroyFn stream_destroy;
  bool ok;
};

const Driver& driver() {
  static Driver d = [] {
    Driver x;
    x.device_get = reinterpret_cast<DeviceGetFn>(driver_fn("cuDeviceGet"));
    x.get_resource = reinterpret_cast<GetDevResourceFn>(driver_fn("cuDeviceGetDevResource"));
    x.split = reinterpret_cast<SplitByCountFn>(driver_fn("cuDevSmResourceSplitByCount"));
    x.desc = reinterpret_cast<GenerateDescFn>(driver_fn("cuDevResourceGenerateDesc"));
    x.ctx_create = reinterpret_cast<GreenCtxCreateFn>(driver_fn("cuGreenCtxCreate"));
    x.stream_create = reinterpret_cast<GreenCtxStreamCreateFn>(driver_fn("cuGreenCtxStreamCreate"));
    x.ctx_destroy = reinterpret_cast<GreenCtxDestroyFn>(driver_fn("cuGreenCtxDestroy"));
    x.stream_destroy = reinterpret_cast<StreamDestroyFn>(driver_fn("cuStreamDestroy"));
    x.ok = x.device_get && x.get_resource && x.split && x.desc && x.ctx_create &&
           x.stream_create && x.ctx_destroy && x.stream_destroy;
    return x;
  }();
  return d;
}

// The device's SM resource. The runtime call first makes sure the primary
// context exists, as the driver calls need an initialised driver.
CUresult device_resource(int device, CUdevice* dev, CUdevResource* res) {
  const Driver& d = driver();
  if (!d.ok) return CUDA_ERROR_NOT_SUPPORTED;
  if (cudaFree(nullptr) != cudaSuccess) return CUDA_ERROR_NOT_INITIALIZED;
  CUresult r = d.device_get(dev, device);
  if (r != CUDA_SUCCESS) return r;
  return d.get_resource(*dev, res, CU_DEV_RESOURCE_TYPE_SM);
}

constexpr int kProbeThreads = 32;
constexpr int kProbeSmem = 120 * 1024;    // more than half of an SM's 228 KB

__global__ void smid_probe_kernel(int* out, long long spin_cycles) {
  extern __shared__ int pad[];
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  const long long t0 = clock64();
  while (clock64() - t0 < spin_cycles) {
  }
  if (threadIdx.x == 0) {
    pad[0] = static_cast<int>(smid);
    out[blockIdx.x] = pad[0];
  }
}

}  // namespace

// The device's SM count, and the smallest group a split makes (a split
// asking for 1 SM: the driver rounds a request up to its granularity).
extern "C" int repro_sm_count(int device, int* sms, int* granule) {
  CUdevice dev;
  CUdevResource res;
  CUresult r = device_resource(device, &dev, &res);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  *sms = static_cast<int>(res.sm.smCount);
  CUdevResource group, rest;
  unsigned int n = 1;
  r = driver().split(&group, &n, &res, &rest, 0, 1);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  *granule = n == 1 ? static_cast<int>(group.sm.smCount) : 0;
  return n == 1 ? CUDA_SUCCESS : CUDA_ERROR_INVALID_RESOURCE_CONFIGURATION;
}

// Two disjoint partitions of the device: a group of at least `first_sms`
// SMs (rounded up by the driver) and the rest. Writes each one's SM count,
// green context and stream (non-blocking, default priority).
extern "C" int repro_sm_split(int device, int first_sms, int* sms_out, void** ctx_out,
                              void** stream_out) {
  const Driver& d = driver();
  CUdevice dev;
  CUdevResource res;
  CUresult r = device_resource(device, &dev, &res);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  CUdevResource parts[2];
  unsigned int n = 1;
  r = d.split(&parts[0], &n, &res, &parts[1], 0, static_cast<unsigned int>(first_sms));
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  if (n != 1 || parts[1].sm.smCount == 0) return CUDA_ERROR_INVALID_RESOURCE_CONFIGURATION;
  CUgreenCtx ctx[2] = {nullptr, nullptr};
  CUstream stream[2] = {nullptr, nullptr};
  for (int i = 0; i < 2 && r == CUDA_SUCCESS; ++i) {
    CUdevResourceDesc desc;
    r = d.desc(&desc, &parts[i], 1);
    if (r == CUDA_SUCCESS) r = d.ctx_create(&ctx[i], desc, dev, CU_GREEN_CTX_DEFAULT_STREAM);
    if (r == CUDA_SUCCESS)
      r = d.stream_create(&stream[i], ctx[i], CU_STREAM_NON_BLOCKING, 0);
  }
  if (r != CUDA_SUCCESS) {
    for (int i = 0; i < 2; ++i) {
      if (stream[i]) d.stream_destroy(stream[i]);
      if (ctx[i]) d.ctx_destroy(ctx[i]);
    }
    return static_cast<int>(r);
  }
  for (int i = 0; i < 2; ++i) {
    sms_out[i] = static_cast<int>(parts[i].sm.smCount);
    ctx_out[i] = ctx[i];
    stream_out[i] = stream[i];
  }
  return CUDA_SUCCESS;
}

// Destroys a partition made by repro_sm_split (its stream first).
extern "C" int repro_sm_release(void* ctx, void* stream) {
  const Driver& d = driver();
  if (!d.ok) return CUDA_ERROR_NOT_SUPPORTED;
  CUresult r = d.stream_destroy(static_cast<CUstream>(stream));
  const CUresult r2 = d.ctx_destroy(static_cast<CUgreenCtx>(ctx));
  return static_cast<int>(r != CUDA_SUCCESS ? r : r2);
}

extern "C" const char* repro_sm_driver_error_string(int err) {
  auto fn = reinterpret_cast<GetErrorStringFn>(driver_fn("cuGetErrorString"));
  const char* s = nullptr;
  if (fn == nullptr || fn(static_cast<CUresult>(err), &s) != CUDA_SUCCESS || s == nullptr)
    return "unknown driver error (or the driver has no green-context API)";
  return s;
}

// n_ctas CTAs, each writing its SM id to out[blockIdx.x] after spinning
// spin_cycles clock cycles. Returns a cudaError_t.
extern "C" int repro_smid_probe(int* out, int n_ctas, long long spin_cycles, void* stream) {
  if (n_ctas <= 0 || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(smid_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kProbeSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  smid_probe_kernel<<<n_ctas, kProbeThreads, kProbeSmem, static_cast<cudaStream_t>(stream)>>>(
      out, spin_cycles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_smid_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
