// Annealing select step (Metropolis accept + per-chain incumbent update),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/search.py::_kernel (launched by
// _pallas_select, pallas_call at :76).  Same function, decided per chain
// from (P,) objectives and broadcast over (P, L) int32 assignment rows:
//   temp     = max(*temp, 1e-30), temp read from the device in the
//              objectives' dtype (no host value is baked into the launch,
//              so a captured graph replays with each step's temperature)
//   accept   = (delta <= 0 || u < exp(-delta / temp)) && isfinite(prop_obj)
//   improved = prop_obj < best_obj            (strict: first-found wins)
//   new_cur  = accept ? prop : cur;  new_best = improved ? prop : best
// exp is the precise exp/expf and -delta / temp an IEEE division (no fast
// math), so the decision is bit for bit the one torch.exp makes in the
// plain version; a NaN delta (both objectives infinite) fails both
// comparisons and rejects.
//
// What bounds it on the card: it reads three rows and four scalars per
// chain and writes two rows and two scalars (3*P*L*4 + 4*P*sizeof(T) bytes
// in, 2*P*L*4 + 2*P*sizeof(T) out) with a handful of operations each, so
// it is bound by bytes over 3.35 TB/s; at the search's populations (P up
// to a few thousand, L = workloads x padded groups) one launch is shorter
// than the time to start it, so what a launch costs past the start is its
// latency: the dependent memory round trips on its critical path.
//
// Design.  A group of LANES lanes (a power of two, at most a warp: the
// block is LANES x 256/LANES threads) owns one chain, so the chain and
// the column come from threadIdx with no division.  Every lane issues
// its loads at once: lane 0 the chain's four scalars and the temperature,
// every lane its first piece of each row the decision can pick.  Lane 0
// decides and hands the two bits to its group with one __shfl_sync; the
// lanes then select in registers and store.  That is one memory round
// trip, where one thread per element had two (the scalars, then the row
// load that waited on the decision) and a 64-bit division each.  Rows
// move as 16-byte int4 pieces when L % 4 == 0 and every row pointer is
// 16-byte aligned (L 64: 16 lanes a row, two chains a warp), else as
// 4-byte ints; the C entry picks.  Rows longer than LANES pieces loop.
//
// In place.  When the outputs are the inputs (cur, cur_obj, best,
// best_obj), as in the search's step, select_kernel_inplace reads only
// prop and the scalars and stores only the rows and objectives whose
// decision changes them; it reads cur and best not at all.  The aliased
// pointers carry no __restrict__ there: the out-of-place kernel's
// signature promises that no output aliases an input.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// Bit 0: accept, bit 1: improved; computed by lane 0 of each group (the
// only lane that reads the scalars) and broadcast to its LANES lanes.
// Every thread of a block reaches the shuffle (no early return), and the
// block's threads fill whole warps.
template <typename T>
__device__ __forceinline__ int decide(bool lead, T co, T po, T bo, T u,
                                      T temp, int lanes) {
  int bits = 0;
  if (lead) {
    temp = temp > T(1e-30) ? temp : T(1e-30);
    const T delta = po - co;
    const bool accept =
        (delta <= T(0) || u < exp_t(-delta / temp)) && isfinite(po);
    const bool improved = po < bo;
    bits = (accept ? 1 : 0) | (improved ? 2 : 0);
  }
  return __shfl_sync(FULL, bits, 0, lanes);
}

// U: the piece of a row one lane moves at a time (int4 or int).
template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
select_kernel(const U* __restrict__ cur, const U* __restrict__ prop,
              const U* __restrict__ best, const T* __restrict__ cur_obj,
              const T* __restrict__ prop_obj, const T* __restrict__ best_obj,
              const T* __restrict__ u, const T* __restrict__ temp_in,
              U* __restrict__ new_cur, T* __restrict__ new_cur_obj,
              U* __restrict__ new_best, T* __restrict__ new_best_obj,
              int P, int pieces) {
  const int lanes = blockDim.x, lane = threadIdx.x;
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = p < P, lead = live && lane == 0;
  const int row = live ? p * pieces : 0;
  T co = T(0), po = T(0), bo = T(0), up = T(0), temp = T(0);
  if (lead) {
    co = cur_obj[p]; po = prop_obj[p]; bo = best_obj[p]; up = u[p];
    temp = *temp_in;
  }
  U c{}, pr{}, b{};
  if (live && lane < pieces) {
    c = cur[row + lane]; pr = prop[row + lane]; b = best[row + lane];
  }
  const int bits = decide(lead, co, po, bo, up, temp, lanes);
  if (!live) return;
  const bool accept = bits & 1, improved = bits & 2;
  for (int j = lane; j < pieces; j += lanes) {
    if (j != lane) {
      c = cur[row + j]; pr = prop[row + j]; b = best[row + j];
    }
    new_cur[row + j] = accept ? pr : c;
    new_best[row + j] = improved ? pr : b;
  }
  if (lead) {
    new_cur_obj[p] = accept ? po : co;
    new_best_obj[p] = improved ? po : bo;
  }
}

template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
select_kernel_inplace(U* cur, const U* __restrict__ prop, U* best,
                      T* cur_obj, const T* __restrict__ prop_obj,
                      T* best_obj, const T* __restrict__ u,
                      const T* __restrict__ temp_in, int P, int pieces) {
  const int lanes = blockDim.x, lane = threadIdx.x;
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = p < P, lead = live && lane == 0;
  const int row = live ? p * pieces : 0;
  T co = T(0), po = T(0), bo = T(0), up = T(0), temp = T(0);
  if (lead) {
    co = cur_obj[p]; po = prop_obj[p]; bo = best_obj[p]; up = u[p];
    temp = *temp_in;
  }
  U pr{};
  if (live && lane < pieces) pr = prop[row + lane];
  const int bits = decide(lead, co, po, bo, up, temp, lanes);
  if (!live || bits == 0) return;
  const bool accept = bits & 1, improved = bits & 2;
  for (int j = lane; j < pieces; j += lanes) {
    if (j != lane) pr = prop[row + j];
    if (accept) cur[row + j] = pr;
    if (improved) best[row + j] = pr;
  }
  if (lead) {
    if (accept) cur_obj[p] = po;
    if (improved) best_obj[p] = po;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, typename U>
int launch_as(const void* cur, const void* prop, const void* best,
              const void* cur_obj, const void* prop_obj,
              const void* best_obj, const void* u, const void* temp,
              void* new_cur, void* new_cur_obj, void* new_best,
              void* new_best_obj, int P, int pieces, bool inplace,
              cudaStream_t stream) {
  int lanes = 1;
  while (lanes < pieces && lanes < 32) lanes <<= 1;
  const dim3 block(lanes, THREADS / lanes);
  const int blocks = (P + (int)block.y - 1) / (int)block.y;
  if (inplace)
    select_kernel_inplace<T, U><<<blocks, block, 0, stream>>>(
        static_cast<U*>(new_cur), static_cast<const U*>(prop),
        static_cast<U*>(new_best), static_cast<T*>(new_cur_obj),
        static_cast<const T*>(prop_obj), static_cast<T*>(new_best_obj),
        static_cast<const T*>(u), static_cast<const T*>(temp), P, pieces);
  else
    select_kernel<T, U><<<blocks, block, 0, stream>>>(
        static_cast<const U*>(cur), static_cast<const U*>(prop),
        static_cast<const U*>(best), static_cast<const T*>(cur_obj),
        static_cast<const T*>(prop_obj), static_cast<const T*>(best_obj),
        static_cast<const T*>(u), static_cast<const T*>(temp),
        static_cast<U*>(new_cur), static_cast<T*>(new_cur_obj),
        static_cast<U*>(new_best), static_cast<T*>(new_best_obj), P,
        pieces);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* cur, const void* prop, const void* best,
           const void* cur_obj, const void* prop_obj, const void* best_obj,
           const void* u, const void* temp, void* new_cur,
           void* new_cur_obj, void* new_best, void* new_best_obj, int P,
           int L, cudaStream_t stream) {
  const bool inplace = new_cur == cur && new_best == best &&
                       new_cur_obj == cur_obj && new_best_obj == best_obj;
  const bool vec = L % 4 == 0 && aligned16(cur) && aligned16(prop) &&
                   aligned16(best) && aligned16(new_cur) &&
                   aligned16(new_best);
  if (vec)
    return launch_as<T, int4>(cur, prop, best, cur_obj, prop_obj, best_obj,
                              u, temp, new_cur, new_cur_obj, new_best,
                              new_best_obj, P, L / 4, inplace, stream);
  return launch_as<T, int>(cur, prop, best, cur_obj, prop_obj, best_obj, u,
                           temp, new_cur, new_cur_obj, new_best,
                           new_best_obj, P, L, inplace, stream);
}

}  // namespace

extern "C" {

// cur, prop, best, new_cur, new_best: (P, L) int32 row-major; cur_obj,
// prop_obj, best_obj, u, new_cur_obj, new_best_obj: (P,) of one dtype
// (0 = float32, 1 = float64), all on the device; temp: one value of that
// dtype on the device.  The outputs are either all four the matching
// inputs (in place) or overlap no input.  P * L < 2^31.  Returns
// cudaGetLastError() after launch.
int anneal_select_fwd(const void* cur, const void* prop, const void* best,
                      const void* cur_obj, const void* prop_obj,
                      const void* best_obj, const void* u, const void* temp,
                      void* new_cur, void* new_cur_obj, void* new_best,
                      void* new_best_obj, long long P, int L, int dtype,
                      void* stream) {
  if (P < 0 || L < 1 || P * (long long)L >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(cur, prop, best, cur_obj, prop_obj, best_obj, u,
                         temp, new_cur, new_cur_obj, new_best, new_best_obj,
                         (int)P, L, s);
  if (dtype == 1)
    return launch<double>(cur, prop, best, cur_obj, prop_obj, best_obj, u,
                          temp, new_cur, new_cur_obj, new_best, new_best_obj,
                          (int)P, L, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
