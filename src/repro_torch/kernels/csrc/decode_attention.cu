// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (launched by decode_attention, pallas_call at :72).  Same function: one
// query token per sequence over a (B, S, Hkv, D) cache with per-sequence
// lengths read on the device; kv tiles at or past the length are skipped,
// positions >= length are masked and their keys zeroed (the 0 * NaN
// guard); f32 softmax state; a length of 0 gives 0, not NaN.
//
// What bounds it on the card: each cached k/v byte is used for ~2 FLOPs
// per query head of its group, far below the H100's ~295 FLOP/byte ridge,
// so it is bound by the bytes of the live cache region (2 * sum(lengths)
// * Hkv * D * sizeof(kv)) over 3.35 TB/s.
//
// Design.  The TPU grid (b, q_head, kv_tile) carries the online softmax
// across its sequential kv axis; here one block owns one (b, kv-head) and
// loops over 128-key tiles up to that sequence's length, so the cache is
// read once for the whole GQA group and nothing past the length is read.
// Per tile: the K tile is staged in shared memory (coalesced rows, f32,
// padded), thread t scores key t for every head of the group, one warp per
// head folds the tile into (m, l) with shuffles, and threads own
// (head, d) outputs, reading V straight from device memory in coalesced
// rows.  Only the V rows below the length are read.  One block per
// (b, kv-head) is few blocks for a small batch; splitting the kv axis
// across blocks with a combine pass is later work.  It matters most for
// MQA: recurrentgemma-9b's 16 query heads over one kv head of 256 give
// one block per sequence (G * D = 4096 outputs, 172.7 KB of shared
// memory).  Head sizes 32, 64, 128 and 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BKV = 128;            // keys per tile = threads per block
constexpr int THREADS = 128;
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
  return __float2bfloat16(x);
}

template <int D>
int smem_floats(int G) {
  return BKV * (D + 1) + G * D + G * BKV + G * D + 3 * G;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
              const TKV* __restrict__ vc, const int* __restrict__ lengths,
              TQ* __restrict__ o, int S, int Hq, int Hkv, float scale) {
  constexpr int DP = D + 1;
  const int G = Hq / Hkv;
  extern __shared__ float smem[];
  float* Ks = smem;                 // BKV x DP
  float* qs = Ks + BKV * DP;        // G x D, scaled
  float* ps = qs + G * D;           // G x BKV scores, then probabilities
  float* acc = ps + G * BKV;        // G x D
  float* ms = acc + G * D;          // G running max
  float* ls = ms + G;               // G running denominator
  float* as = ls + G;               // G rescale of this tile

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = hk * G;
  const int len = min(max(lengths[b], 0), S);

  const TQ* qb = q + ((size_t)b * Hq + h0) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = to_f(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = M_INIT;
    ls[g] = 0.f;
  }

  const size_t row = (size_t)Hkv * D;
  const TKV* kb = kc + (size_t)b * S * row + (size_t)hk * D;
  const TKV* vb = vc + (size_t)b * S * row + (size_t)hk * D;

  for (int t0 = 0; t0 < len; t0 += BKV) {      // tiles past len: skipped
    const int n = min(BKV, len - t0);
    __syncthreads();                // init done / last tile's readers done
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D;
      Ks[r * DP + c] = r < n ? to_f(kb[(size_t)(t0 + r) * row + c]) : 0.f;
    }
    __syncthreads();

    const float* kr = Ks + tid * DP;
    for (int g = 0; g < G; ++g) {
      const float* qg = qs + g * D;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
      ps[g * BKV + tid] = tid < n ? s : -CUDART_INF_F;
    }
    __syncthreads();

    for (int g = warp; g < G; g += THREADS / 32) {
      float* pg = ps + g * BKV;
      float sv[BKV / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i) {
        sv[i] = pg[lane + 32 * i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);   // finite: masked -> exp = 0
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i) {
        const float p = expf(sv[i] - m_new);
        pg[lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        as[g] = a;
        ls[g] = ls[g] * a + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, c = i % D;
      const float* pg = ps + g * BKV;
      const TKV* vcol = vb + (size_t)t0 * row + c;
      float a = acc[i] * as[g];
#pragma unroll 8
      for (int r = 0; r < n; ++r) a = fmaf(pg[r], to_f(vcol[(size_t)r * row]), a);
      acc[i] = a;
    }
  }
  __syncthreads();

  TQ* ob = o + ((size_t)b * Hq + h0) * D;
  for (int i = tid; i < G * D; i += THREADS)
    ob[i] = from_f<TQ>(acc[i] / fmaxf(ls[i / D], 1e-30f));
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int S, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  const int bytes = smem_floats<D>(Hq / Hkv) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  decode_kernel<TQ, TKV, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(lengths),
      static_cast<TQ*>(o), S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_d(const void* q, const void* k, const void* v, const void* lengths,
             void* o, int B, int S, int Hq, int Hkv, int D, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, lengths, o, B, S, Hq, Hkv, scale,
                                 stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, lengths, o, B, S, Hq, Hkv, scale,
                                 stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, lengths, o, B, S, Hq, Hkv, scale,
                                  stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, lengths, o, B, S, Hq, Hkv, scale,
                                  stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ>
int launch_kv(const void* q, const void* k, const void* v,
              const void* lengths, void* o, int kv_dtype, int B, int S, int Hq,
              int Hkv, int D, float scale, cudaStream_t stream) {
  if (kv_dtype == 0)
    return launch_d<TQ, float>(q, k, v, lengths, o, B, S, Hq, Hkv, D, scale,
                               stream);
  if (kv_dtype == 1)
    return launch_d<TQ, __nv_bfloat16>(q, k, v, lengths, o, B, S, Hq, Hkv, D,
                                       scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: (B, 1, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) int32 on the
// device; o: (B, 1, Hq, D) of q's type.  dtypes: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after launch.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int q_dtype,
                         int kv_dtype, int B, int S, int Hq, int Hkv, int D,
                         float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_kv<float>(q, k, v, lengths, o, kv_dtype, B, S, Hq, Hkv, D,
                            scale, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(q, k, v, lengths, o, kv_dtype, B, S, Hq,
                                    Hkv, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
