// Batched piecewise-linear PCCS slowdown surface, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/slowdown.py::_kernel
// (launched by _pallas_piecewise, pallas_call at :75).  Same function:
// bilinear interpolation of a K x M calibration table over (own, ext)
// demand, clamped to the end knot outside the grid, and exactly 1 where
// own <= 0 or ext <= 0.  float32 and float64 (the search's x64 mode),
// 1 <= K, M <= 32.
//
// What bounds it on the card: each element reads two demands and writes
// one slowdown (3 * N * sizeof(T) bytes, 0.06 us at the search's N 8192
// in float64) and does a few dozen operations on them, eight of them
// divisions.  At the search's sizes a launch is far shorter than the
// time to start one, so what is left is the chain of latencies inside
// it: one memory round trip, then the dependent arithmetic.  Of that,
// the eight divisions weigh most: each is a reciprocal refined by fmas
// with a branch to a slow path, and the compiler keeps the eight in
// sequence.  They stay, since they set the bits the search's checks hold
// (dropping the two whose quotient is provably >= 1 added branches and
// measured slower).
//
// Design.  Nothing is staged and nothing waits at a barrier.  At its
// start each lane issues, together, its loads of own and ext and of one
// knot of each axis and one table entry (lane l holds own_knots[l],
// ext_knots[l] and, where K * M <= 32 as for the 5 x 5 PCCS table,
// table[l]): every element then waits on one memory round trip.  The
// bracket on each axis (the last knot <= x, kept in [0, n - 2]) is a
// compare against each knot fetched by __shfl_sync from the lane that
// holds it; the knots around it and the four table entries come the same
// way, or, for a larger table, by __ldg after the bracket (a second
// round trip, from L1/L2).  Warps walk the elements in a grid-stride
// loop with the loop condition uniform across the warp, so every lane
// takes part in the shuffles.  Blocks are small (the wrapper's
// kernels/slowdown.py::launch_grid: 128 threads) so that the search's
// 8192 elements spread over 64 SMs.
//
// Arithmetic.  Each element's operations and their order are those of
// this kernel's first design, which the search's float64 checks were
// taken with: the two non-zero hat weights of each axis by the
// oracle's own formula (repro/kernels/ref.py:32-52: the max(k - kprev,
// 1e-30) guard for repeated knots, min of rising and falling edge clipped
// to [0, 1], weight 1 on an end knot for x at or beyond it), all eight
// divisions kept, then s = hi0 * A + hi1 * B with A = r0[j] * hj0 +
// r0[j+1] * hj1 and B likewise, which nvcc had contracted into fma(x, y,
// z * w) for each x * y + z * w; on a table of one row or one column,
// s = w0 * t[i] + w1 * t[i+1], contracted into fma(w1, t[i+1], w0 *
// t[i]).  Those fmas are written out here (fma_rn, mul_rn), so the bits
// no longer depend on the compiler's contraction.  For sorted knots
// every other hat weight is exactly 0, so the result differs from the
// TPU kernel's contraction only in summation order.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_KNOTS = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float fma_rn(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_rn(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

// Hat weight of knot k between its neighbours kprev and knext (the
// oracle's _hat_weights, one column); `first` / `last`: k is the first /
// the last knot.
template <typename T>
__device__ __forceinline__ T hat(T kprev, T k, T knext, bool first,
                                 bool last, T x) {
  const T tiny = T(1e-30);
  const T dk0 = k - kprev, dk1 = knext - k;
  const T up = (x - kprev) / (dk0 > tiny ? dk0 : tiny);
  const T dn = (knext - x) / (dk1 > tiny ? dk1 : tiny);
  T h = up < dn ? up : dn;
  h = h < T(0) ? T(0) : (h > T(1) ? T(1) : h);
  if (first && x <= k) h = T(1);
  if (last && x >= k) h = T(1);
  return h;
}

template <typename T>
struct Bracket {
  int i;          // lower knot, in [0, n - 2]
  T w0, w1;       // hat weights of knots i and i + 1
};

// The bracket of x among n >= 2 lane-held knots (lane l holds knot l):
// the last knot <= x, kept in [0, n - 2].  Every lane of the warp calls
// it.
template <typename T>
__device__ __forceinline__ Bracket<T> bracket(T held, int n, T x) {
  int i = 0;
  for (int q = 1; q < n - 1; ++q)
    if (__shfl_sync(FULL, held, q) <= x) i = q;
  const T km = __shfl_sync(FULL, held, i > 0 ? i - 1 : 0);
  const T k0 = __shfl_sync(FULL, held, i);
  const T k1 = __shfl_sync(FULL, held, i + 1);
  const T k2 = __shfl_sync(FULL, held, i + 2 < n ? i + 2 : n - 1);
  return {i, hat(km, k0, k1, i == 0, false, x),
          hat(k0, k1, k2, false, i + 1 == n - 1, x)};
}

template <typename T>
__global__ void slowdown_kernel(const T* __restrict__ own,
                                const T* __restrict__ ext,
                                const T* __restrict__ own_knots,
                                const T* __restrict__ ext_knots,
                                const T* __restrict__ table,
                                T* __restrict__ out, long long n, int K,
                                int M) {
  const int lane = threadIdx.x % 32;
  const bool held = K * M <= 32;      // the table rides in the lanes too
  const T okl = lane < K ? own_knots[lane] : T(0);
  const T ekl = lane < M ? ext_knots[lane] : T(0);
  const T tl = held && lane < K * M ? table[lane] : T(0);
  auto entry = [&](int idx) {
    return held ? __shfl_sync(FULL, tl, idx) : __ldg(table + idx);
  };

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x
                        - lane;
       base < n; base += stride) {      // uniform across the warp
    const long long e = base + lane;
    const bool live = e < n;
    const T o = live ? own[e] : T(1), x = live ? ext[e] : T(1);
    T s;
    if (K == 1 && M == 1) {
      s = entry(0);
    } else if (K == 1) {
      const Bracket<T> j = bracket(ekl, M, x);
      s = fma_rn(j.w1, entry(j.i + 1), mul_rn(j.w0, entry(j.i)));
    } else if (M == 1) {
      const Bracket<T> i = bracket(okl, K, o);
      s = fma_rn(i.w1, entry(i.i + 1), mul_rn(i.w0, entry(i.i)));
    } else {
      const Bracket<T> i = bracket(okl, K, o), j = bracket(ekl, M, x);
      const int r0 = i.i * M + j.i, r1 = r0 + M;
      const T A = fma_rn(entry(r0), j.w0, mul_rn(entry(r0 + 1), j.w1));
      const T B = fma_rn(entry(r1), j.w0, mul_rn(entry(r1 + 1), j.w1));
      s = fma_rn(i.w0, A, mul_rn(i.w1, B));
    }
    if (live) out[e] = (o <= T(0) || x <= T(0)) ? T(1) : s;
  }
}

template <typename T>
int launch(const void* own, const void* ext, const void* ok, const void* ek,
           const void* tab, void* out, long long n, int K, int M,
           int blocks, int threads, cudaStream_t stream) {
  slowdown_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(own), static_cast<const T*>(ext),
      static_cast<const T*>(ok), static_cast<const T*>(ek),
      static_cast<const T*>(tab), static_cast<T*>(out), n, K, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// own, ext, out: (n,) contiguous; own_knots (K,), ext_knots (M,), table
// (K, M) row-major, all of one dtype (0 = float32, 1 = float64) on the
// device; 1 <= K, M <= 32.  blocks x threads is the grid
// kernels/slowdown.py::launch_grid chose (threads a multiple of 32, at
// most 1024).  Returns cudaGetLastError() after launch.
int piecewise_slowdown_fwd(const void* own, const void* ext,
                           const void* own_knots, const void* ext_knots,
                           const void* table, void* out, long long n, int K,
                           int M, int dtype, int blocks, int threads,
                           void* stream) {
  if (K < 1 || M < 1 || K > MAX_KNOTS || M > MAX_KNOTS || n < 0
      || blocks < 1 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(own, ext, own_knots, ext_knots, table, out, n, K, M,
                         blocks, threads, s);
  if (dtype == 1)
    return launch<double>(own, ext, own_knots, ext_knots, table, out, n, K,
                          M, blocks, threads, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
