// Streaming antagonist pass (float32 saxpy), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/profiling/probes.py::_stream_kernel
// (launched by _pallas_stream, pallas_call at :51).  Same function:
// o = x * float32(1.0000001) + y over n float32 elements, reading two
// operands and writing one (12 bytes per element).
//
// What bounds it on the card: one multiply and one add per 12 bytes, so it
// is bound by bytes over 3.35 TB/s (HBM) once the operands exceed the 50 MB
// L2; a pass that fits in L2 is bound by the L2's rate, and a pass of a few
// MB by the time to start the launch.
//
// Design.  The TPU kernel padded to a 4096-element block and sliced the
// result back; here the padding is gone and the edges are handled in the
// kernel.  A grid-stride loop moves 16 bytes per thread per operand
// (float4 loads and stores, neighbouring threads on neighbouring
// addresses); a scalar head covers the elements before the first 16-byte
// boundary, so any 4-byte-aligned offset (x[1:]) takes the vector path,
// and a scalar tail covers the last n % 4.  When x, y and o do not share
// their offset modulo 16 the whole pass is scalar.  The grid is one wave
// of resident blocks (8 of 256 threads on each of the 132 SMs).
//
// Rounding.  The product and the sum are rounded separately
// (__fmul_rn, __fadd_rn): nvcc may not contract them into an FMA, so the
// kernel equals the plain version x * c + y bit for bit, NaN, infinities,
// signed zeros and subnormals included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 8;
// the float32 nearest 1.0000001 (jnp.float32(1.0000001) in the reference)
constexpr float SCALE = 1.00000011920928955f;

__device__ __forceinline__ float saxpy(float x, float y) {
  return __fadd_rn(__fmul_rn(x, SCALE), y);
}

__global__ void __launch_bounds__(THREADS)
stream_vec_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ o, long long n, int head) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (tid < head) o[tid] = saxpy(x[tid], y[tid]);
  const long long nvec = (n - head) / 4;
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  const float4* __restrict__ yv = reinterpret_cast<const float4*>(y + head);
  float4* __restrict__ ov = reinterpret_cast<float4*>(o + head);
  for (long long i = tid; i < nvec; i += stride) {
    const float4 a = xv[i], b = yv[i];
    float4 r;
    r.x = saxpy(a.x, b.x);
    r.y = saxpy(a.y, b.y);
    r.z = saxpy(a.z, b.z);
    r.w = saxpy(a.w, b.w);
    ov[i] = r;
  }
  for (long long i = head + nvec * 4 + tid; i < n; i += stride)
    o[i] = saxpy(x[i], y[i]);
}

__global__ void __launch_bounds__(THREADS)
stream_scalar_kernel(const float* __restrict__ x,
                     const float* __restrict__ y, float* __restrict__ o,
                     long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride)
    o[i] = saxpy(x[i], y[i]);
}

int grid_for(long long work) {
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// x, y, o: n contiguous float32 on the device, each 4-byte aligned.
// Returns cudaGetLastError() after launch.
int stream_fwd(const float* x, const float* y, float* o, long long n,
               void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x) & 15;
  const uintptr_t ay = reinterpret_cast<uintptr_t>(y) & 15;
  const uintptr_t ao = reinterpret_cast<uintptr_t>(o) & 15;
  if ((ax | ay | ao) & 3) return (int)cudaErrorMisalignedAddress;
  if (ax == ay && ay == ao) {
    long long head = (long long)((16 - ax) & 15) / 4;
    if (head > n) head = n;
    stream_vec_kernel<<<grid_for((n - head) / 4), THREADS, 0, s>>>(
        x, y, o, n, (int)head);
  } else {
    stream_scalar_kernel<<<grid_for(n), THREADS, 0, s>>>(x, y, o, n);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
