// RWKV-6 (Finch) time-mix recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::_kernel (launched by
// rwkv6_scan, pallas_call at :68).  Same function, per (batch, head) with
// a float32 state S of D x Dv:
//
//     y_t = r_t^T (S + (u ⊙ k_t) v_t^T)
//     S   = diag(w_t) S + k_t v_t^T
//
// r, k, w: (B, T, H, D); v: (B, T, H, Dv); u: (H, D); state0 (float32 or
// NULL for zeros) and the final state: (B, H, D, Dv) float32; y: (B, T, H,
// Dv) in v's type.  Any T >= 1 and any D, Dv <= 64; there is no padding in
// time, so the TPU kernel's padded-step guard has nothing to guard.
//
// What bounds it on the card: ~4 D Dv FLOP per (b, t, h) (r^T S and the
// rank-1 state update) in float32 on the CUDA cores, against the bytes of
// r, k, v, w, y and both states.  At a prefill of B = 1, T = 1000, H = 64,
// D = Dv = 64 in bf16 that is 1.05 GFLOP (15.7 us at 67 TFLOP/s) against
// 43 MB (12.9 us at 3.35 TB/s): the operations bind.  At a decode step
// (B = 4, T = 1) the 8.4 MB of state read and written bind (2.5 us).
//
// Design.  The TPU grid (b, h, time tile) keeps the state in VMEM scratch
// across its sequential time axis; here one block of 64 threads owns one
// (b, h) and walks time itself.  Thread j owns column j of the state, its
// D floats in registers, so y_j = sum_i r_i (S_ij + u_i k_i v_j) and the
// update S_ij <- w_i S_ij + k_i v_j need no exchange between threads.  The
// block stages CH = 16 steps of r, k, w and v at a time in shared memory
// (coalesced rows, converted to f32, zero past D and Dv: a zero r, k and
// w keep the padded rows of S at 0 and add nothing to y), and every
// thread reads the same r_i, k_i, w_i, u_i (broadcast, no bank conflict).
//
// Rounding.  Every product and sum of the state update and of the terms
// r_i (S_ij + u_i k_i v_j) is rounded on its own (__fmul_rn, __fadd_rn),
// as the plain version's eager ops round them, and the D terms of y_j are
// summed by halving (term_i += term_{i+w} for w = 32, 16, ..., 1; the
// terms past D are 0), the fixed order in which the plain version sums
// them.  So the kernel equals the plain version bit for bit, and a
// difference end to end is a fault, not rounding amplified through the
// layers.  The halving tree is also only 6 adds deep.
//
// What this costs: B * H blocks of two warps (64 blocks at batch 1 on 132
// SMs) each doing its steps in sequence leave most of the card idle;
// splitting D across warps, or a chunked form on the tensor cores, is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 64;            // largest D and Dv; threads per block
constexpr int CH = 16;              // steps staged in shared memory at once

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
  return __float2bfloat16(x);
}

// one level of the halving sum: t_i += t_{i+W} for i < W
template <int W>
__device__ __forceinline__ void halve(float* t) {
#pragma unroll
  for (int i = 0; i < W; ++i) t[i] = __fadd_rn(t[i], t[i + W]);
}

template <typename T>
__global__ void __launch_bounds__(MAXD)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const T* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ y, float* __restrict__ sT, int Tn, int H, int D,
             int Dv) {
  __shared__ float rs[CH][MAXD], ks[CH][MAXD], ws[CH][MAXD], vs[CH][MAXD];
  __shared__ float us[MAXD];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  us[j] = j < D ? to_f(u[(size_t)h * D + j]) : 0.f;

  // column j of the state; rows past D stay 0
  float Sj[MAXD];
  const float* s0b = s0 != nullptr ? s0 + bh * D * Dv : nullptr;
#pragma unroll
  for (int i = 0; i < MAXD; ++i)
    Sj[i] = (s0b != nullptr && i < D && j < Dv) ? s0b[(size_t)i * Dv + j]
                                                : 0.f;

  const size_t row_k = (size_t)H * D;       // stride of one step in r, k, w
  const size_t row_v = (size_t)H * Dv;      // in v and y
  const T* rb = r + (size_t)b * Tn * row_k + (size_t)h * D;
  const T* kb = k + (size_t)b * Tn * row_k + (size_t)h * D;
  const T* wb = w + (size_t)b * Tn * row_k + (size_t)h * D;
  const T* vb = v + (size_t)b * Tn * row_v + (size_t)h * Dv;
  T* yb = y + (size_t)b * Tn * row_v + (size_t)h * Dv;

  for (int t0 = 0; t0 < Tn; t0 += CH) {
    __syncthreads();                // us ready / last chunk's readers done
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      const int t = t0 + c;
      const bool live = t < Tn;
      const size_t ok = (size_t)t * row_k + j, ov = (size_t)t * row_v + j;
      rs[c][j] = live && j < D ? to_f(rb[ok]) : 0.f;
      ks[c][j] = live && j < D ? to_f(kb[ok]) : 0.f;
      ws[c][j] = live && j < D ? to_f(wb[ok]) : 0.f;
      vs[c][j] = live && j < Dv ? to_f(vb[ov]) : 0.f;
    }
    __syncthreads();
    const int n = min(CH, Tn - t0);
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float term[MAXD];
#pragma unroll
      for (int i = 0; i < MAXD; ++i) {
        const float kv = __fmul_rn(ks[c][i], vj);
        term[i] = __fmul_rn(__fadd_rn(Sj[i], __fmul_rn(us[i], kv)), rs[c][i]);
        Sj[i] = __fadd_rn(__fmul_rn(ws[c][i], Sj[i]), kv);
      }
      halve<32>(term);              // constant bounds keep term[] in
      halve<16>(term);              // registers
      halve<8>(term);
      halve<4>(term);
      halve<2>(term);
      halve<1>(term);
      if (j < Dv) yb[(size_t)(t0 + c) * row_v + j] = from_f<T>(term[0]);
    }
  }

  if (j < Dv) {
    float* sb = sT + bh * D * Dv;
#pragma unroll
    for (int i = 0; i < MAXD; ++i)
      if (i < D) sb[(size_t)i * Dv + j] = Sj[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B, int Tn,
           int H, int D, int Dv, cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv6_kernel<T><<<grid, MAXD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), Tn, H, D, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, w: (B, T, H, D); v, y: (B, T, H, Dv); u: (H, D); all contiguous
// and of one type (0 = float32, 1 = bfloat16).  s0 (NULL: zeros) and sT:
// (B, H, D, Dv) float32.  1 <= D, Dv <= 64.  Returns cudaGetLastError()
// after launch.
int rwkv6_fwd(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sT, int dtype,
              int B, int Tn, int H, int D, int Dv, void* stream) {
  if (B < 0 || Tn < 1 || H < 0 || D < 1 || D > MAXD || Dv < 1 || Dv > MAXD
      || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, y, sT, B, Tn, H, D, Dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, Tn, H, D, Dv,
                                 s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
