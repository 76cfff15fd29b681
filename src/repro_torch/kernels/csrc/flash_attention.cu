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
// tensor-core work.  A layer's K and V (8 MB in bf16) fit in the 50 MB
// L2, so the repeated tile reads of the q tiles need not reach HBM; what
// decides the time is how fast the products run.
//
// Two kernels, chosen by type:
// * bfloat16 (the served path): flash_mma, FA2-style mma.sync.  One block
//   owns one (b, q-head, 64-query tile) and 4 warps, each warp 16 query
//   rows.  Q comes in once (A fragments kept in registers up to D = 128,
//   re-read from shared memory by ldmatrix at D = 256); K/V tiles arrive
//   in shared memory as bf16 through a two-stage ring of 16-byte cp.async
//   copies (kv rows past Skv zero-filled, never loaded), rows padded by 8
//   elements so ldmatrix has no bank conflicts.  S = Q.K^T runs as
//   mma.sync.m16n8k16 into f32 registers, the scale is applied to S in
//   f32, the online softmax stays in registers (each row's max and sum
//   reduced across its quad with shuffles), P is split in registers into
//   bf16 hi = bf16(p) and lo = bf16(p - hi), A fragments of two mma for
//   O += P.V (V by ldmatrix.trans), O in f32 registers.  One bf16 P
//   moved served bf16 logits past the reference's argmax check on
//   recurrentgemma-9b; hi + lo keeps ~16 mantissa bits for one more mma
//   per product.  The kv tile is 64 keys, 32 at D = 256 so the 16 x 256
//   f32 accumulator (128 registers a thread) fits beside the scores.
//   Masks are evaluated only on tiles that cut the diagonal, the window
//   edge or the kv tail.  Under a causal mask the q tiles with the most
//   live kv tiles launch first (blockIdx.x reversed).
// * float32: flash_kernel, the first version, left as it was: f32 math on
//   the CUDA cores, so the f32 path meets the reference's 2e-5 tolerance.
//   One block owns one (b, q-head, 64-query tile) and loops over kv tiles
//   itself, with m, l and the 64 x D accumulator in registers.  128
//   threads form a 16 x 8 grid: thread (ty, tx) holds query rows ty + 16i
//   (i < 4), score columns tx + 8j (j < 8) and output columns tx + 8j
//   (j < D/8), so each row's max and sum reduce over 8 neighbouring lanes
//   with shuffles.  Q (scaled in f32), the K and V tiles, and the
//   probabilities live in shared memory as f32, padded so no warp reads
//   two rows in one bank.  At D = 256 the accumulator is 4 x 32 floats a
//   thread and the block takes 215.6 KB of shared memory.
// Head sizes 16 (every reduced config), 32, 64, 80 (hubert-xlarge), 128
// and 256 (recurrentgemma-9b's local layers): multiples of 16, so both
// kernels' tilings hold (the mma k-step and the 16-column ldmatrix.trans
// of V).  The wrapper zero-pads any other head size up to the next one.
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sm90_tiles.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: FA2-style tensor-core kernel
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Mma {
  static constexpr int BKV = D == 256 ? 32 : 64;
  static constexpr int LD = D + 8;                    // padded row
  static constexpr int CH = D / 8;                    // 16 B chunks a row
  static constexpr int NS = BKV / 8;                  // score n-tiles
  static constexpr bool Q_REGS = D <= 128;
  static constexpr int SMEM = (BQ + 2 * 2 * BKV) * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv,
          int Hq, int Hkv, int causal, int window, float scale) {
  using P = Mma<D>;
  constexpr int BK = P::BKV, LD = P::LD, CH = P::CH, NS = P::NS;
  // (a name of its own: flash_kernel declares smem as float)
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* Qs = reinterpret_cast<bf16*>(raw);          // BQ x LD
  bf16* stage = Qs + BQ * LD;                         // [2][K, V][BK][LD]

  // causal: the q tiles with the most live kv tiles first
  const int iq = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = iq * BQ, off = Skv - Sq;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const bf16* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Skv * kv_stride + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * Skv * kv_stride + (size_t)hk * D;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, s = q0 + r;
    sm90::cp_async16(Qs + r * LD + c * 8,
                     qb + (size_t)(s < Sq ? s : 0) * q_stride + c * 8,
                     s < Sq);
  }
  // live kv range, as flash_kernel's (flash_attention.py:71)
  const int first_q = q0 + off;
  const int last_q = min(q0 + BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, last_q + 1) : Skv;
  const int kv_begin =
      window > 0 ? max(0, first_q - window + 1) / BK * BK : 0;
  auto load = [&](int t, int st) {
    bf16* ks = stage + st * 2 * BK * LD;
    bf16* vs = ks + BK * LD;
    const int k0 = kv_begin + t * BK;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, s = k0 + r;
      const bool ok = s < Skv;        // the padded tail: zeros, not loads
      const size_t src = (size_t)(ok ? s : 0) * kv_stride + c * 8;
      sm90::cp_async16(ks + r * LD + c * 8, kb + src, ok);
      sm90::cp_async16(vs + r * LD + c * 8, vb + src, ok);
    }
  };

  const int wr = warp * 16;                           // this warp's rows
  const bf16* Qw = Qs + wr * LD;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};   // rows lane/4, +8
  uint32_t qa[P::Q_REGS ? D / 16 : 1][4];
  const float sl2 = scale * LOG2E;                    // exp2 domain
  const int qp0 = q0 + wr + lane / 4 + off;           // row lane/4's position

  const int nt = (kv_end - kv_begin + BK - 1) / BK;
  load(0, 0);
  sm90::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) load(t + 1, (t + 1) & 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    if (P::Q_REGS && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (P::Q_REGS ? D / 16 : 1); ++kk)
        sm90::ldmatrix_x4(qa[kk], Qw + (lane & 15) * LD + kk * 16
                                      + (lane >> 4) * 8);
    }
    const bf16* ks = stage + (t & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;
    const int k0 = kv_begin + t * BK;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (P::Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
      } else {
        sm90::ldmatrix_x4(a, Qw + (lane & 15) * LD + kk * 16
                                 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        sm90::ldmatrix_x4(kf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8)
                                  * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        sm90::mma_bf16(s[2 * np], a, kf[0], kf[1]);
        sm90::mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // masks only where this tile cuts the kv tail, the diagonal or the
    // window's edge (flash_attention.py:58-59)
    const bool masked = k0 + BK > Skv || (causal && k0 + BK - 1 > first_q)
                        || (window > 0 && k0 <= last_q - window);
    float p[NS][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qp = qp0 + 8 * rr;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[n][2 * rr + c] * sl2;
          if (masked) {
            const int kp = k0 + n * 8 + 2 * (lane % 4) + c;
            bool live = kp < Skv;
            if (causal) live = live && kp <= qp;
            if (window > 0) live = live && kp > qp - window;
            x = live ? x : -CUDART_INF_F;
          }
          s[n][2 * rr + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // m stays finite (>= M_INIT), so masked scores give exp2(-inf) = 0
      const float m_new = fmaxf(m[rr], mx);
      const float al = exp2f(m[rr] - m_new);
      m[rr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          p[n][2 * rr + c] = exp2f(s[n][2 * rr + c] - m_new);
          sum += p[n][2 * rr + c];
        }
      l[rr] = l[rr] * al + sum;       // this thread's columns; quad sum at end
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * rr] *= al;
        acc[n][2 * rr + 1] *= al;
      }
    }

    // O += P.V, P split in registers into bf16 hi + lo (one mma each)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      sm90::split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
      sm90::split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
      sm90::split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
      sm90::split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        uint32_t vf[4];
        sm90::ldmatrix_x4_trans(
            vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0
                    + (lane >> 4) * 8);
        sm90::mma_bf16(acc[n0 / 8], hi, vf[0], vf[1]);
        sm90::mma_bf16(acc[n0 / 8 + 1], hi, vf[2], vf[3]);
        sm90::mma_bf16(acc[n0 / 8], lo, vf[0], vf[1]);
        sm90::mma_bf16(acc[n0 / 8 + 1], lo, vf[2], vf[3]);
      }
    }
    __syncthreads();                // stage t & 1 free for tile t + 2
  }
  sm90::cp_async_wait<0>();

  // out = acc / max(l, 1e-30) (flash_attention.py:88), staged through this
  // warp's own Q rows for 16-byte stores
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
  bf16* Ow = Qs + wr * LD;
  const int gr = lane / 4, gc = 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Ow + gr * LD + n * 8 + gc) =
        sm90::pack_bf16(acc[n][0] * l[0], acc[n][1] * l[0]);
    *reinterpret_cast<uint32_t*>(Ow + (gr + 8) * LD + n * 8 + gc) =
        sm90::pack_bf16(acc[n][2] * l[1], acc[n][3] * l[1]);
  }
  __syncwarp();
  bf16* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, s = q0 + wr + r;
    if (s < Sq)
      *reinterpret_cast<uint4*>(ob + (size_t)s * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + c * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, int causal, int window,
               float scale, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int bytes = Mma<D>::SMEM;
  cudaError_t err = sm90::set_smem_once(flash_mma<D>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_mma<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, Hq, Hkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_mma<D>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                         scale, stream);
  } else {
    static unsigned done = 0;
    const int bytes = smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = sm90::set_smem_once(flash_kernel<T, D>, bytes, done);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv,
        causal, window, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                           scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
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
