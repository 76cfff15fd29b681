// Blocked online-softmax GQA attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention, pallas_call at :113).  Same function:
// queries are the last Sq of the Skv positions, causal / local-window /
// bidirectional masks, fully masked kv tiles skipped, the padded kv tail
// zeroed before the products, f32 softmax state, out = acc / max(l, 1e-30).
//
// What bounds it on the card: a causal prefill at S = 1024 with 32 heads
// of 64 does ~4.3 GFLOP per layer against ~16.8 MB of q/k/v/o, ~256
// FLOP/byte, just under the H100's ~295 FLOP/byte ridge (989 TFLOP/s bf16
// over 3.35 TB/s), so its bound is the bytes: ~5.0 us against ~4.3 us of
// tensor-core work.  The design reads each q tile once, stages each K/V
// tile once per q tile in shared memory and never loads the tiles a mask
// hides; a layer's K and V (8 MB in bf16) fit in the 50 MB L2, so the
// repeated tile reads need not reach HBM.  What holds this first version
// far above that bound is not the bytes but the arithmetic: it computes in
// f32 on the CUDA cores (so the f32 path meets the reference's 2e-5
// tolerance), whose rate is a small fraction of the tensor cores'.
// wgmma/TMA tiles are later work.
//
// Design.  The TPU's grid (b, h, q_tile, kv_tile) runs its kv axis in
// order, carrying m / l / acc in VMEM scratch; here one block owns one
// (b, q-head, 64-query tile) and loops over kv tiles itself, with m, l and
// the 64 x D accumulator in registers.  128 threads form a 16 x 8 grid:
// thread (ty, tx) holds query rows ty + 16i (i < 4), score columns
// tx + 8j (j < 8) and output columns tx + 8j (j < D/8), so each row's
// max and sum reduce over 8 neighbouring lanes with shuffles.  Q (scaled
// in f32), the K and V tiles, and the probabilities live in shared memory
// as f32, padded so no warp reads two rows in one bank.  Head sizes 32,
// 64, 128 and 256 (recurrentgemma-9b's local layers); at 256 the
// accumulator is 4 x 32 floats a thread (ptxas: 240 registers, no spill)
// and the block takes 215.6 KB of the 227 KB of shared memory, one block
// per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr int PP = BKV + 8;         // probability row stride (bank spread)
constexpr float M_INIT = -1e30f;    // running max before any live key

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
  return __float2bfloat16(x);     // round to nearest even, as astype does
}

template <int D>
constexpr int smem_floats() {
  return 2 * BQ * (D + 1) + BKV * D + BQ * PP;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
             int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ  x DP
  float* Ks = Qs + BQ * DP;         // BKV x DP
  float* Vs = Ks + BKV * DP;        // BKV x D
  float* Ps = Vs + BKV * D;         // BQ  x PP

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);    // GQA: kv head of this q head
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int q0 = iq * BQ;
  const int off = Skv - Sq;         // queries are the last Sq positions

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * kv_stride + (size_t)hk * D;

  // the scale is applied to q in f32 (flash_attention.py:44)
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * DP + c] = s < Sq ? to_f(qb[(size_t)s * q_stride + c]) * scale
                            : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = M_INIT;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // live kv range: tiles wholly above the causal diagonal or wholly
  // before every query's window are never visited (flash_attention.py:71)
  const int first_q = q0 + off;
  const int last_q = min(q0 + BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, last_q + 1) : Skv;
  const int kv_begin =
      window > 0 ? max(0, first_q - window + 1) / BKV * BKV : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();                // Qs ready / last tile's readers done
    // zero the padded kv tail: p is 0 there, but 0 * NaN would poison acc
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool ok = s < Skv;
      Ks[r * DP + c] = ok ? to_f(kb[(size_t)s * kv_stride + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f(vb[(size_t)s * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r + off;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool live = kp < Skv && qp < Skv;      // flash_attention.py:58-59
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && kp > qp - window;
        sc[i][j] = live ? sc[i][j] : -CUDART_INF_F;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // m stays finite (>= M_INIT), so masked scores give exp(-inf) = 0
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[r * PP + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[kk * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);     // flash_attention.py:88
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)s * q_stride + tx + 8 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); o: (B, Sq, Hq, D), all
// contiguous and of one type.  dtype: 0 = float32, 1 = bfloat16.
// window <= 0: no local window.  Returns cudaGetLastError() after launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
                        int D, int causal, int window, float scale,
                        void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq > Skv) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                           scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                                   window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
