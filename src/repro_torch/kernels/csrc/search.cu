// Annealing select step (Metropolis accept + per-chain incumbent update),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/search.py::_kernel (launched by
// _pallas_select, pallas_call at :76).  Same function, decided per chain
// from (P,) objectives and broadcast over (P, L) int32 assignment rows:
//   temp     = max(temp, 1e-30) in the objectives' dtype
//   accept   = (delta <= 0 || u < exp(-delta / temp)) && isfinite(prop_obj)
//   improved = prop_obj < best_obj            (strict: first-found wins)
//   new_cur  = accept ? prop : cur;  new_best = improved ? prop : best
// exp is the precise exp/expf (no fast math), so the decision is bit for
// bit the one torch.exp makes in the plain version; a NaN delta (both
// objectives infinite) fails both comparisons and rejects.
//
// What bounds it on the card: it reads three rows and four scalars per
// chain and writes two rows and two scalars (3*P*L*4 + 4*P*sizeof(T) bytes
// in, 2*P*L*4 + 2*P*sizeof(T) out) with a handful of operations each, so
// it is bound by bytes over 3.35 TB/s; at the search's populations (P up
// to a few thousand, L = workloads x padded groups) one launch is shorter
// than the time to start it.
//
// Design.  The TPU kernel blocked the chain axis with the row riding whole
// in VMEM.  Here one thread owns one (chain, column) element over a
// grid-stride loop, so the row loads and stores are coalesced; each thread
// recomputes its chain's decision from the (P,) vectors (L-fold redundant
// scalar reads that hit L1), and column 0 writes the two objectives.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
select_kernel(const int* __restrict__ cur, const int* __restrict__ prop,
              const int* __restrict__ best, const T* __restrict__ cur_obj,
              const T* __restrict__ prop_obj, const T* __restrict__ best_obj,
              const T* __restrict__ u, double temp_in,
              int* __restrict__ new_cur, T* __restrict__ new_cur_obj,
              int* __restrict__ new_best, T* __restrict__ new_best_obj,
              long long P, int L) {
  T temp = static_cast<T>(temp_in);
  temp = temp > T(1e-30) ? temp : T(1e-30);
  const long long n = P * (long long)L;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += stride) {
    const long long p = e / L;
    const int col = (int)(e - p * L);
    const T co = cur_obj[p], po = prop_obj[p], bo = best_obj[p];
    const T delta = po - co;
    const bool accept =
        (delta <= T(0) || u[p] < exp_t(-delta / temp)) && isfinite(po);
    const bool improved = po < bo;
    new_cur[e] = accept ? prop[e] : cur[e];
    new_best[e] = improved ? prop[e] : best[e];
    if (col == 0) {
      new_cur_obj[p] = accept ? po : co;
      new_best_obj[p] = improved ? po : bo;
    }
  }
}

template <typename T>
int launch(const void* cur, const void* prop, const void* best,
           const void* cur_obj, const void* prop_obj, const void* best_obj,
           const void* u, double temp, void* new_cur, void* new_cur_obj,
           void* new_best, void* new_best_obj, long long P, int L,
           cudaStream_t stream) {
  long long blocks = (P * (long long)L + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond this
  select_kernel<T><<<(int)blocks, THREADS, 0, stream>>>(
      static_cast<const int*>(cur), static_cast<const int*>(prop),
      static_cast<const int*>(best), static_cast<const T*>(cur_obj),
      static_cast<const T*>(prop_obj), static_cast<const T*>(best_obj),
      static_cast<const T*>(u), temp, static_cast<int*>(new_cur),
      static_cast<T*>(new_cur_obj), static_cast<int*>(new_best),
      static_cast<T*>(new_best_obj), P, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cur, prop, best, new_cur, new_best: (P, L) int32 row-major; cur_obj,
// prop_obj, best_obj, u, new_cur_obj, new_best_obj: (P,) of one dtype
// (0 = float32, 1 = float64), all on the device; temp is cast to that
// dtype on the device.  Returns cudaGetLastError() after launch.
int anneal_select_fwd(const void* cur, const void* prop, const void* best,
                      const void* cur_obj, const void* prop_obj,
                      const void* best_obj, const void* u, double temp,
                      void* new_cur, void* new_cur_obj, void* new_best,
                      void* new_best_obj, long long P, int L, int dtype,
                      void* stream) {
  if (P < 0 || L < 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(cur, prop, best, cur_obj, prop_obj, best_obj, u,
                         temp, new_cur, new_cur_obj, new_best, new_best_obj,
                         P, L, s);
  if (dtype == 1)
    return launch<double>(cur, prop, best, cur_obj, prop_obj, best_obj, u,
                          temp, new_cur, new_cur_obj, new_best, new_best_obj,
                          P, L, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
