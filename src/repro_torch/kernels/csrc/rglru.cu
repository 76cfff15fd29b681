// Gated linear recurrence (the RG-LRU core) for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::_kernel (launched by
// rglru_scan, pallas_call at :63).  Same function: h_t = a_t h_{t-1} + b_t
// along the time axis of (B, S, D) inputs, channels independent, with an
// optional float32 h0 (zeros without one); every h_t is returned in a's
// type and h_last in float32, as ref.linear_scan and _linear_scan_xla
// return it (the Pallas path returns a's type).  There is no padding, so
// the TPU kernel's "padded steps hold h" guard has nothing to guard: any
// S >= 1 and any D are taken as they are.
//
// What bounds it on the card: one multiply and one add for every three
// elements moved (a and b read, h written), so it is bound by bytes:
// 3 * B * S * D * sizeof(a) over 3.35 TB/s, ~7.3 us at B = 1, S = 1000,
// D = 4096 in bf16 (24.6 MB).
//
// Design.  The TPU grid (b, channel tile, time tile) walks time innermost
// with the carry in VMEM scratch; here one thread owns one (b, channel),
// keeps h in an f32 register and walks t itself.  Neighbouring threads own
// neighbouring channels, so every step's loads of a and b and store of h
// are coalesced rows.  The loads of U = 8 steps are issued before their 8
// dependent updates, so 16 loads are in flight per thread rather than 2.
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn),
// as the plain version's two eager ops round them, so in float32 the
// kernel equals the plain version bit for bit.  What this costs: B * D
// threads (4096 at batch 1: 32 blocks of 128 on 132 SMs) walking S steps
// in sequence leave most of the card idle and each step waits on a load's
// latency, far from the byte bound; a chunked parallel scan (chunks of
// time in separate blocks, then a pass carrying each chunk's h in) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;                // steps whose loads are issued together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);     // round to nearest even, as .to() does
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ h,
             float* __restrict__ h_last, int S, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const size_t bi = blockIdx.y;
  if (c >= D) return;
  const size_t base = bi * S * D + c;
  float hv = h0 != nullptr ? h0[bi * D + c] : 0.f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const size_t o = base + (size_t)(t + i) * D;
      av[i] = to_f(a[o]);
      bv[i] = to_f(b[o]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      hv = step(av[i], hv, bv[i]);
      h[base + (size_t)(t + i) * D] = from_f<T>(hv);
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + (size_t)t * D;
    hv = step(to_f(a[o]), hv, to_f(b[o]));
    h[o] = from_f<T>(hv);
  }
  h_last[bi * D + c] = hv;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* h,
           void* h_last, int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(h),
      static_cast<float*>(h_last), S, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, h: (B, S, D) contiguous, of one type (0 = float32, 1 = bfloat16);
// h0: (B, D) float32 or NULL (zeros); h_last: (B, D) float32.
// Returns cudaGetLastError() after launch.
int rglru_fwd(const void* a, const void* b, const void* h0, void* h,
              void* h_last, int dtype, int B, int S, int D, void* stream) {
  if (B < 0 || S < 1 || D < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, h, h_last, B, S, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, S, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
