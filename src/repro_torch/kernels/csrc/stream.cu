// Streaming antagonist (float32 saxpy), for Hopper (sm_90a).
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
// Two kernels:
// * stream_pass, one pass (the probe's timed target and its peak pass).
//   Each thread keeps UNROLL independent 16-byte loads of each operand in
//   flight before its stores.  Plain loads and stores: with evict-first
//   hints (__ldcs/__stcs) on both, a 1 GB pass took 0.3526 ms on an H100,
//   slower than the first design's 0.3451 ms; without them 0.3294 ms
//   (chip_smoke.py), so only the antagonist below keeps them.  Each block
//   owns a fixed chunk of THREADS * UNROLL float4s (neighbouring threads
//   on neighbouring addresses for every load) and the grid covers the
//   work, never one resident wave with a grid-stride loop: when the
//   duty-cycled antagonist below holds part of some SMs, the block
//   scheduler gives those SMs fewer blocks, where a one-wave grid would
//   run its left-over blocks as a second wave, so a co-run would time
//   lost SM slots instead of contended memory.  A scalar head
//   covers the elements before the first 16-byte boundary (any 4-byte
//   aligned offset, x[1:], takes the vector path) and a scalar tail the
//   last n % 4; when x, y and o differ in their offset modulo 16 the pass
//   is scalar.
// * stream_duty, the co-run antagonist: one launch streams the buffer over
//   and over for demand * period of every period and sleeps the rest
//   (__nanosleep), by the device's %globaltimer, until a device flag is
//   raised or a deadline passes; the duty cycle is held on the device, not
//   paced by a host thread.  Every block asks for more than half an SM's
//   shared memory, so each SM holds at most one: the wrapper's grid is
//   the number of SMs the antagonist may hold, and a block of 512 threads
//   leaves three quarters of those SMs' thread slots to the target.  With
//   UNROLL 16-byte loads of each operand in flight a thread, 33 such blocks
//   keep ~2 MB in flight, about what HBM's rate times its latency asks
//   for.  Each warp streams units of 32 x UNROLL float4s on its own (no
//   block barrier), and reads the clock and the flag through lane 0.  Its
//   loads and stores carry evict-first hints (__ldcs/__stcs), so that it
//   contends for HBM more than for the target's L2.  The bytes moved and
//   the first and last streaming times are gathered into a device counter.
//
// Rounding.  The product and the sum are rounded separately
// (__fmul_rn, __fadd_rn): nvcc may not contract them into an FMA, so every
// kernel equals the plain version x * c + y bit for bit, NaN, infinities,
// signed zeros and subnormals included.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                   // float4 loads in flight
constexpr long long CHUNK = (long long)THREADS * UNROLL;   // float4 a block
constexpr int DUTY_THREADS = 512;
// more than half of an SM's 228 KB of shared memory: one block an SM
constexpr int DUTY_SMEM = 116 * 1024;
// the float32 nearest 1.0000001 (jnp.float32(1.0000001) in the reference)
constexpr float SCALE = 1.00000011920928955f;

__device__ __forceinline__ float saxpy(float x, float y) {
  return __fadd_rn(__fmul_rn(x, SCALE), y);
}

__device__ __forceinline__ float4 saxpy4(float4 a, float4 b) {
  float4 r;
  r.x = saxpy(a.x, b.x);
  r.y = saxpy(a.y, b.y);
  r.z = saxpy(a.z, b.z);
  r.w = saxpy(a.w, b.w);
  return r;
}

// ---------------------------------------------------------------------------
// one pass
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
stream_pass(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ o, long long n, int head) {
  const int tid = threadIdx.x;
  const long long nvec = (n - head) / 4;
  if (blockIdx.x == 0) {
    if (tid < head) o[tid] = saxpy(x[tid], y[tid]);
    const long long tail = head + nvec * 4 + tid;
    if (tail < n) o[tail] = saxpy(x[tail], y[tail]);
  }
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  const float4* __restrict__ yv = reinterpret_cast<const float4*>(y + head);
  float4* __restrict__ ov = reinterpret_cast<float4*>(o + head);
  const long long base = (long long)blockIdx.x * CHUNK + tid;
  float4 a[UNROLL], b[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + u * THREADS;
    if (i < nvec) {
      a[u] = xv[i];
      b[u] = yv[i];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + u * THREADS;
    if (i < nvec) ov[i] = saxpy4(a[u], b[u]);
  }
}

__global__ void __launch_bounds__(THREADS)
stream_pass_scalar(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ o, long long n) {
  const long long base = (long long)blockIdx.x * CHUNK * 4 + threadIdx.x;
  float a[UNROLL * 4], b[UNROLL * 4];
#pragma unroll
  for (int u = 0; u < UNROLL * 4; ++u) {
    const long long i = base + u * THREADS;
    if (i < n) {
      a[u] = x[i];
      b[u] = y[i];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL * 4; ++u) {
    const long long i = base + u * THREADS;
    if (i < n) o[i] = saxpy(a[u], b[u]);
  }
}

int blocks_for(long long work, long long per_block) {
  const long long blocks = (work + per_block - 1) / per_block;
  return (int)(blocks < 1 ? 1 : blocks);
}

// ---------------------------------------------------------------------------
// the duty-cycled antagonist
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// moved[0]: bytes streamed; moved[1], moved[2]: the first and last
// %globaltimer readings at which a warp streamed (set to ~0 and 0 by the
// caller before the launch).
__global__ void __launch_bounds__(DUTY_THREADS, 1)
stream_duty(const float4* __restrict__ x, const float4* __restrict__ y,
            float4* __restrict__ o, long long n4, long long period_ns,
            long long burst_ns, long long max_ns, const int* stop,
            unsigned long long* moved) {
  constexpr int WARPS = DUTY_THREADS / 32;
  constexpr long long UNIT = 32LL * UNROLL;          // float4s a warp unit
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * WARPS;
  const long long units = (n4 + UNIT - 1) / UNIT;
  long long k = ((long long)blockIdx.x * WARPS + threadIdx.x / 32) % units;
  const unsigned long long begin =
      __shfl_sync(0xffffffffu, lane == 0 ? global_ns() : 0ull, 0);
  unsigned long long bytes = 0, first = ~0ull, last = 0;
  for (unsigned iter = 0;; ++iter) {
    unsigned long long now = lane == 0 ? global_ns() : 0ull;
    int halt = 0;
    if (lane == 0 && (iter & 7) == 0) halt = __ldcv(stop);
    now = __shfl_sync(0xffffffffu, now, 0);
    halt = __shfl_sync(0xffffffffu, halt, 0);
    if (halt || now - begin >= (unsigned long long)max_ns) break;
    const long long phase = (long long)(now % (unsigned long long)period_ns);
    if (phase >= burst_ns) {
      // short naps: __nanosleep may sleep up to twice what it is asked
      const long long rest = period_ns - phase;
      __nanosleep((unsigned)(rest < 2000 ? rest : 2000));
      continue;
    }
    const long long base = k * UNIT + lane;
    float4 a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * 32;
      if (i < n4) {
        a[u] = __ldcs(x + i);
        b[u] = __ldcs(y + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * 32;
      if (i < n4) {
        __stcs(o + i, saxpy4(a[u], b[u]));
        bytes += 48;
      }
    }
    first = now < first ? now : first;
    last = now;
    k += warps;
    if (k >= units) k %= units;
  }
#pragma unroll
  for (int w = 16; w > 0; w /= 2)
    bytes += __shfl_xor_sync(0xffffffffu, bytes, w);
  if (lane == 0 && bytes) {
    atomicAdd(moved, bytes);
    atomicMin(moved + 1, first);
    atomicMax(moved + 2, last);
  }
}

// the number of elements before x's first 16-byte boundary, or -1 when x,
// y and o differ in their offset modulo 16 (or are not 4-byte aligned: -2)
long long vector_head(const float* x, const float* y, const float* o,
                      long long n) {
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x) & 15;
  const uintptr_t ay = reinterpret_cast<uintptr_t>(y) & 15;
  const uintptr_t ao = reinterpret_cast<uintptr_t>(o) & 15;
  if ((ax | ay | ao) & 3) return -2;
  if (ax != ay || ay != ao) return -1;
  const long long head = (long long)((16 - ax) & 15) / 4;
  return head < n ? head : n;
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
  const long long head = vector_head(x, y, o, n);
  if (head == -2) return (int)cudaErrorMisalignedAddress;
  if (head >= 0)
    stream_pass<<<blocks_for((n - head) / 4, CHUNK), THREADS, 0, s>>>(
        x, y, o, n, (int)head);
  else
    stream_pass_scalar<<<blocks_for(n, CHUNK * 4), THREADS, 0, s>>>(x, y, o,
                                                                     n);
  return (int)cudaGetLastError();
}

// The duty-cycled antagonist over n4 float4s of x, y and o (16-byte
// aligned), on `blocks` SMs (one block each), streaming burst_ns of every
// period_ns until *stop is non-zero or max_ns have passed.  moved: three
// unsigned 64-bit counters (bytes, first and last streaming time; the
// caller sets them to 0, ~0 and 0).  Returns cudaGetLastError() after
// launch.
int stream_duty_fwd(const void* x, const void* y, void* o, long long n4,
                    long long period_ns, long long burst_ns, long long max_ns,
                    const int* stop, unsigned long long* moved, int blocks,
                    void* stream) {
  if (n4 < 1 || period_ns < 1 || burst_ns < 1 || burst_ns > period_ns
      || max_ns < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)
       | reinterpret_cast<uintptr_t>(o)) & 15)
    return (int)cudaErrorMisalignedAddress;
  static unsigned done = 0;
  cudaError_t err = sm90::set_smem_once(stream_duty, DUTY_SMEM, done);
  if (err != cudaSuccess) return (int)err;
  stream_duty<<<blocks, DUTY_THREADS, DUTY_SMEM,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(y),
      static_cast<float4*>(o), n4, period_ns, burst_ns, max_ns, stop, moved);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
