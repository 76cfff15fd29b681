// Batched piecewise-linear PCCS slowdown surface, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/slowdown.py::_kernel
// (launched by _pallas_piecewise, pallas_call at :75).  Same function:
// bilinear interpolation of a K x M calibration table over (own, ext)
// demand, clamped to the end knot outside the grid, and exactly 1 where
// own <= 0 or ext <= 0.  float32 and float64 (the search's x64 mode).
//
// What bounds it on the card: each element reads two demands and writes
// one slowdown (3 * N * sizeof(T) bytes) and does a few dozen operations
// on them, so it is bound by bytes over 3.35 TB/s; at the search's sizes
// (N = chains x workloads, ~10^4) a launch is far shorter than the time
// to start one, so in practice it is bound by launch latency.
//
// Design.  The TPU kernel expressed the lookup as a hat-basis contraction
// (hatO @ table @ hatE^T) only because gathers are slow on a TPU; here
// gathers from shared memory are cheap, so each thread finds its bracket
// on each axis with a short linear search and reads four table entries.
// The knots and the table (K, M <= 32) are staged once per block in
// shared memory; one thread per element over a grid-stride loop, loads
// and stores coalesced.  The two non-zero hat weights of each axis are
// computed with the oracle's own formula (repro/kernels/ref.py:32-52): the
// max(k - kprev, 1e-30) guard for repeated knots, min of rising and
// falling edge clipped to [0, 1], and weight 1 on an end knot for x at or
// beyond it.  For sorted knots every other hat weight is exactly 0, so the
// result differs from the contraction only in summation order.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KNOTS = 32;

// Hat weight of knot c for x (the oracle's _hat_weights, one column).
template <typename T>
__device__ __forceinline__ T hat(const T* knots, int n, int c, T x) {
  const T tiny = T(1e-30);
  const T k = knots[c];
  const T kprev = knots[c > 0 ? c - 1 : 0];
  const T knext = knots[c < n - 1 ? c + 1 : n - 1];
  const T dk0 = k - kprev, dk1 = knext - k;
  const T up = (x - kprev) / (dk0 > tiny ? dk0 : tiny);
  const T dn = (knext - x) / (dk1 > tiny ? dk1 : tiny);
  T h = up < dn ? up : dn;
  h = h < T(0) ? T(0) : (h > T(1) ? T(1) : h);
  if (c == 0 && x <= knots[0]) h = T(1);
  if (c == n - 1 && x >= knots[n - 1]) h = T(1);
  return h;
}

// Lower knot of the bracket: the last knot <= x, kept in [0, n - 2].
template <typename T>
__device__ __forceinline__ int bracket(const T* knots, int n, T x) {
  int c = 0;
  for (int i = 1; i < n - 1; ++i)
    if (knots[i] <= x) c = i;
  return c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
slowdown_kernel(const T* __restrict__ own, const T* __restrict__ ext,
                const T* __restrict__ own_knots,
                const T* __restrict__ ext_knots, const T* __restrict__ table,
                T* __restrict__ out, long long n, int K, int M) {
  __shared__ T ok[MAX_KNOTS];
  __shared__ T ek[MAX_KNOTS];
  __shared__ T tab[MAX_KNOTS * MAX_KNOTS];
  for (int i = threadIdx.x; i < K; i += THREADS) ok[i] = own_knots[i];
  for (int i = threadIdx.x; i < M; i += THREADS) ek[i] = ext_knots[i];
  for (int i = threadIdx.x; i < K * M; i += THREADS) tab[i] = table[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += stride) {
    const T o = own[e], x = ext[e];
    if (o <= T(0) || x <= T(0)) {
      out[e] = T(1);
      continue;
    }
    T s;
    if (K == 1 && M == 1) {
      s = tab[0];
    } else if (K == 1) {
      const int j = bracket(ek, M, x);
      s = hat(ek, M, j, x) * tab[j] + hat(ek, M, j + 1, x) * tab[j + 1];
    } else if (M == 1) {
      const int i = bracket(ok, K, o);
      s = hat(ok, K, i, o) * tab[i] + hat(ok, K, i + 1, o) * tab[i + 1];
    } else {
      const int i = bracket(ok, K, o), j = bracket(ek, M, x);
      const T hi0 = hat(ok, K, i, o), hi1 = hat(ok, K, i + 1, o);
      const T hj0 = hat(ek, M, j, x), hj1 = hat(ek, M, j + 1, x);
      const T* r0 = tab + i * M;
      const T* r1 = r0 + M;
      s = hi0 * (r0[j] * hj0 + r0[j + 1] * hj1) +
          hi1 * (r1[j] * hj0 + r1[j + 1] * hj1);
    }
    out[e] = s;
  }
}

template <typename T>
int launch(const void* own, const void* ext, const void* ok, const void* ek,
           const void* tab, void* out, long long n, int K, int M,
           cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond this
  slowdown_kernel<T><<<(int)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(own), static_cast<const T*>(ext),
      static_cast<const T*>(ok), static_cast<const T*>(ek),
      static_cast<const T*>(tab), static_cast<T*>(out), n, K, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// own, ext, out: (n,) contiguous; own_knots (K,), ext_knots (M,), table
// (K, M) row-major, all of one dtype (0 = float32, 1 = float64) on the
// device; 1 <= K, M <= 32.  Returns cudaGetLastError() after launch.
int piecewise_slowdown_fwd(const void* own, const void* ext,
                           const void* own_knots, const void* ext_knots,
                           const void* table, void* out, long long n, int K,
                           int M, int dtype, void* stream) {
  if (K < 1 || M < 1 || K > MAX_KNOTS || M > MAX_KNOTS || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(own, ext, own_knots, ext_knots, table, out, n, K, M,
                         s);
  if (dtype == 1)
    return launch<double>(own, ext, own_knots, ext_knots, table, out, n, K,
                          M, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
