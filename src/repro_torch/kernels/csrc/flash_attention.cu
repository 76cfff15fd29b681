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
// Three kernels, chosen by the dtype and the head size alone (route()):
// * bfloat16 at D = 64 and 128 (every served transformer's heads):
//   flash_sm90, the TMA ring and warp-specialised wgmma.  One block owns
//   one (b, q-head, 128-query tile): two consumer warpgroups of 64 query
//   rows and a producer warpgroup (setmaxnreg: 24 registers a producer
//   thread, 240 a consumer one).  One producer thread keeps a ring of 128-
//   key K and V tiles (3 stages at D = 128, 4 at D = 64) full with TMA
//   boxes of 64 columns (the 128-byte swizzle's width), each tile on a
//   full mbarrier of its own, each stage freed by an empty mbarrier every
//   consumer thread arrives on; q, k, v and o are 4-D tensor maps
//   (D, H, S, B), so rows past a sequence read zeros and stores past it
//   write nothing.  S = Q.K^T is wgmma m64n128k16 from shared memory
//   (both operands K-major), the scale and the online softmax in f32
//   registers (four partial maxima and sums a row, quads reduced with
//   shuffles, ex2.approx), P split in registers into bf16 hi and lo, the
//   A operands of two wgmma m64nDk16 for O += P.V (V read MN-major), O in
//   f32 registers.  Building with -DFLASH_SM90_P_PIECES=1 keeps one bf16
//   P and one P.V product a tile, as FA3 and the library call do; it is
//   faster but brings llama3.2-3b's served logits close to their 2e-2
//   limit, so the served build keeps two pieces (PERF.md, PR 28).
//   A warpgroup issues tile t's S and tile t - 1's P.V together; the two
//   warpgroups take turns to issue (named barriers), so one's softmax
//   runs under the other's products.  A tile of at most 64 query rows
//   (a prompt that short, or a prompt's last tile) runs on one warpgroup.  The output leaves through the
//   warpgroup's Q rows as a TMA store.  The q tile is the slowest grid
//   index, so causal prefills hand out every head's heaviest tile first.
//   What bounds it: at S 1024 the causal tail of a 1.5-4 wave grid; at
//   S 4096 the tensor cores (P.V twice over, for P's two halves) and the
//   softmax's exponentials (16 a clock an SM: a 128 x 128 tile's take
//   about half as long as its products at D = 128).
// * bfloat16 at the other head sizes (16, 32, 80, 256): flash_mma, FA2-
//   style mma.sync.  One block
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
// and 256 (recurrentgemma-9b's local layers): multiples of 16, so the
// kernels' tilings hold (the mma k-step and the 16-column ldmatrix.trans
// of V).  The wrapper zero-pads any other head size up to the next one.
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bfloat16 at D = 64 and 128: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------
template <int D>
struct Sm90 {
  static constexpr int BQ = 128;                  // query rows a block
  static constexpr int WQ = 64;                   // rows a consumer warpgroup
  static constexpr int BK = 128;                  // keys a kv tile
  static constexpr int STAGES = D == 64 ? 4 : 3;  // K/V ring depth
  static constexpr int THREADS = 3 * 128;         // 2 consumer warpgroups
                                                  // and the producer's
  // registers a thread after setmaxnreg, within the 384 x 168 the block
  // is launched with: 128 x 24 + 256 x 240 = 64,512
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int BOXES = D / 64;            // 128-byte boxes a row
  static constexpr int Q_BOX = BQ * 128;          // bytes of a Q box column
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX; // one K or one V tile
  static constexpr int BARS = 1 + 3 * STAGES;     // q, k, v full; empty
  // + 1024: the dynamic base is rounded up to the swizzle atom's boundary
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

// P's bf16 pieces in flash_sm90's O += P.V: 2 (hi + lo, the served
// build) or 1
#ifndef FLASH_SM90_P_PIECES
#define FLASH_SM90_P_PIECES 2
#endif
static_assert(FLASH_SM90_P_PIECES == 1 || FLASH_SM90_P_PIECES == 2,
              "FLASH_SM90_P_PIECES must be 1 or 2");
constexpr bool SPLIT_P = FLASH_SM90_P_PIECES == 2;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(Sm90<D>::THREADS, 1)
flash_sm90(const __grid_constant__ CUtensorMap qm,
           const __grid_constant__ CUtensorMap km,
           const __grid_constant__ CUtensorMap vm,
           const __grid_constant__ CUtensorMap om, int Sq, int Skv, int Hq,
           int Hkv, int causal, int window, float scale) {
  using P = Sm90<D>;
  constexpr int BK = P::BK, ST = P::STAGES;
  extern __shared__ __align__(1024) unsigned char raw_tma[];
  unsigned char* Qs =
      raw_tma + ((1024 - (sm90::smem_addr(raw_tma) & 1023)) & 1023);
  unsigned char* Ks = Qs + P::Q_BYTES;              // [ST][BOXES][BK][128 B]
  unsigned char* Vs = Ks + ST * P::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * P::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  // the q tile is the slowest grid index, so under a causal mask every
  // head's heaviest tile is handed out first (longest first)
  const int iq = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = iq * P::BQ, off = Skv - Sq;
  // live kv range, as flash_kernel's (flash_attention.py:71)
  const int first_q = q0 + off;
  const int last_q = min(q0 + P::BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, last_q + 1) : Skv;
  const int kv_begin =
      window > 0 ? max(0, first_q - window + 1) / BK * BK : 0;
  const int nt = (kv_end - kv_begin + BK - 1) / BK;
  const int tid = threadIdx.x;
  // a tile of at most 64 query rows (a prompt that short, or a prompt's
  // last tile) runs on consumer warpgroup 0 alone
  const bool solo = Sq - q0 <= P::WQ;
  const int consumers = solo ? 1 : 2;

  if (tid == 0) {
    sm90::bar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::bar_init(&k_full[s], 1);
      sm90::bar_init(&v_full[s], 1);
      sm90::bar_init(&empty[s], consumers * 128); // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    sm90::regs_dec<P::PRODUCER_REGS>();
    // The producer: one thread keeps the ring full.  Q comes once, each
    // warpgroup's 64 rows as boxes of their own; K and V tiles each
    // arrive on a barrier of their own, so Q.K^T starts before V lands.
    // Rows past Sq or Skv arrive as zeros.
    if (tid == 2 * 128) {
      sm90::bar_expect(q_full, consumers * (P::Q_BYTES / 2));
      for (int c = 0; c < P::BOXES; ++c)
        for (int w = 0; w < consumers; ++w)
          sm90::tma_load4(Qs + c * P::Q_BOX + w * P::WQ * 128, &qm, q_full,
                          c * 64, h, q0 + w * P::WQ, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, k0 = kv_begin + t * BK;
        if (t >= ST) sm90::bar_wait(&empty[s], ((t / ST) & 1) ^ 1);
        sm90::bar_expect(&k_full[s], P::KV_BYTES);
        for (int c = 0; c < P::BOXES; ++c)
          sm90::tma_load4(Ks + s * P::KV_BYTES + c * P::KV_BOX, &km,
                          &k_full[s], c * 64, hk, k0, b);
        sm90::bar_expect(&v_full[s], P::KV_BYTES);
        for (int c = 0; c < P::BOXES; ++c)
          sm90::tma_load4(Vs + s * P::KV_BYTES + c * P::KV_BOX, &vm,
                          &v_full[s], c * 64, hk, k0, b);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, warp `warp` rows 16 warp + g and
  // + 8 of them (g = lane / 4), the layout of every accumulator below.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  if (wg >= consumers) return;
  sm90::regs_inc<P::CONSUMER_REGS>();
  const int wq0 = q0 + wg * P::WQ;
  const int w_first = wq0 + off;                    // its positions
  const int w_last = min(wq0 + P::WQ, Sq) - 1 + off;
  const int qp0 = w_first + warp * 16 + lane / 4;   // row g's position
  const float sl2 = scale * LOG2E;                  // exp2 domain
  const uint32_t q_addr = sm90::smem_addr(Qs) + wg * P::WQ * 128;
  const uint32_t k_addr = sm90::smem_addr(Ks);
  const uint32_t v_addr = sm90::smem_addr(Vs);
  float o[D / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};  // rows g, g + 8
  // P of the last tile as bf16 A fragments, hi = bf16(p), lo = bf16(p - hi)
  // (lo unused with one piece)
  uint32_t ph[BK / 16][4], pl[SPLIT_P ? BK / 16 : 1][4];
  sm90::bar_wait(q_full, 0);

  // O += P.V for the tile in stage sp: BK / 16 steps of m64nDk16 for each
  // of P's pieces, V read transposed (MN-major)
  auto gemm_pv = [&](int sp) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sm90::desc_sw128(
          v_addr + sp * P::KV_BYTES + kk * 16 * 128, P::KV_BOX, 1024);
      if constexpr (D == 64) {
        sm90::wgmma_rs_n64(o, ph[kk], dv, 1);
        if constexpr (SPLIT_P) sm90::wgmma_rs_n64(o, pl[kk], dv, 1);
      } else {
        sm90::wgmma_rs_n128(o, ph[kk], dv, 1);
        if constexpr (SPLIT_P) sm90::wgmma_rs_n128(o, pl[kk], dv, 1);
      }
    }
  };
  // S = Q.K^T for the tile in stage s: D / 16 steps of m64n128k16, both
  // operands K-major
  auto gemm_s = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t dq = sm90::desc_sw128(
          q_addr + (kk / 4) * P::Q_BOX + (kk % 4) * 32, 16, 1024);
      const uint64_t dk = sm90::desc_sw128(
          k_addr + s * P::KV_BYTES + (kk / 4) * P::KV_BOX + (kk % 4) * 32,
          16, 1024);
      sm90::wgmma_ss_n128(sc, dq, dk, kk > 0);
    }
  };
  // The online softmax of tile t's scores in sc (four partial maxima and
  // sums a row keep the dependent chains short), O rescaled, and P as
  // bf16 A fragments (hi and lo, or one piece): keys 16 kk .. 16 kk + 15
  // are the 8-column blocks 2 kk and 2 kk + 1 of the score accumulator.
  auto softmax = [&](int t) {
    // masks only where this tile cuts the kv tail, the diagonal or the
    // window's edge for this warpgroup's rows (flash_attention.py:58-59)
    const int k0 = kv_begin + t * BK;
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > w_first)
        || (window > 0 && k0 <= w_last - window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = qp0 + 8 * (i / 2);
          const int kp = k0 + j * 8 + 2 * (lane % 4) + i % 2;
          bool live = kp < Skv;
          if (causal) live = live && kp <= qp;
          if (window > 0) live = live && kp > qp - window;
          if (!live) sc[4 * j + i] = -CUDART_INF_F;
        }
    }
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i / 2][(j % 2) * 2 + i % 2] =
            fmaxf(mx[i / 2][(j % 2) * 2 + i % 2], sc[4 * j + i]);
    float m_new[2], al[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x = fmaxf(fmaxf(mx[rr][0], mx[rr][1]),
                      fmaxf(mx[rr][2], mx[rr][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      // in the exp2 domain; m stays finite (>= M_INIT), so masked
      // scores give exp2(-inf) = 0
      m_new[rr] = fmaxf(m[rr], x * sl2);
      al[rr] = exp2_approx(m[rr] - m_new[rr]);
      m[rr] = m_new[rr];
    }
    float sum[2][4] = {};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2_approx(fmaf(sc[4 * j + i], sl2, -m_new[i / 2]));
        sc[4 * j + i] = p;
        sum[i / 2][(j % 2) * 2 + i % 2] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)    // this thread's columns; quad sum at end
      l[rr] = l[rr] * al[rr] + ((sum[rr][0] + sum[rr][1])
                                + (sum[rr][2] + sum[rr][3]));
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[4 * n + i] *= al[i / 2];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if constexpr (SPLIT_P)
          sm90::split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1],
                           ph[kk][i], pl[kk][i]);
        else
          ph[kk][i] = sm90::pack_bf16(sc[8 * kk + 2 * i],
                                      sc[8 * kk + 2 * i + 1]);
  };

  // Ping-pong: the warpgroups take turns at the tensor cores (named
  // barriers TURN + wg), so one's softmax runs while the other's products
  // do.  A turn issues tile t's S = Q.K^T and tile t - 1's O += P.V
  // together; the softmax of tile t follows outside the turn.  (Running
  // that softmax under the P.V as well measured no faster with P in two
  // halves, and held ph and pl through it, which spilled at D = 128.)
  // Warpgroup 0 goes first; warpgroup 1 skips the hand-over after its
  // last turn, which nobody would wait for; a warpgroup alone takes no
  // turns.  The first and last turns are peeled off, so every wgmma is
  // issued on a path the whole warpgroup takes.
  constexpr int TURN = 3;
  const int mine = TURN + wg, other = TURN + 1 - wg;
  auto take_turn = [&] { if (!solo) sm90::named_sync(mine, 256); };
  auto pass_turn = [&] { if (!solo) sm90::named_arrive(other, 256); };
  if (wg == 1) sm90::named_arrive(TURN, 256);
  sm90::bar_wait(&k_full[0], 0);
  take_turn();
  sm90::wgmma_fence();
  gemm_s(0);
  sm90::wgmma_commit();
  pass_turn();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  softmax(0);
  for (int t = 1; t < nt; ++t) {
    const int s = t % ST, sp = (t - 1) % ST;
    sm90::bar_wait(&k_full[s], (t / ST) & 1);
    sm90::bar_wait(&v_full[sp], ((t - 1) / ST) & 1);
    take_turn();
    sm90::wgmma_fence();
    gemm_s(s);
    gemm_pv(sp);
    sm90::wgmma_commit();
    pass_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(o);
    sm90::fence_regs(ph);
    if constexpr (SPLIT_P) sm90::fence_regs(pl);
    sm90::bar_arrive(&empty[sp]);     // this thread is done with it
    softmax(t);
  }
  const int last = (nt - 1) % ST;
  sm90::bar_wait(&v_full[last], ((nt - 1) / ST) & 1);
  take_turn();
  sm90::wgmma_fence();
  gemm_pv(last);
  sm90::wgmma_commit();
  if (wg == 0) pass_turn();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::fence_regs(ph);
  if constexpr (SPLIT_P) sm90::fence_regs(pl);

  // out = acc / max(l, 1e-30) (flash_attention.py:88) in this warpgroup's
  // Q rows, laid out as the map's 128-byte swizzle, then one TMA store a
  // box (rows past Sq are not written)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
  sm90::named_sync(1 + wg, 128);      // the warpgroup's Q reads are done
  unsigned char* Os = Qs + wg * P::WQ * 128;
  const int r0 = warp * 16 + lane / 4, cb = 4 * (lane % 4);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      *reinterpret_cast<uint32_t*>(Os + (n / 8) * P::Q_BOX + r * 128
                                   + ((n % 8) ^ (r % 8)) * 16 + cb) =
          sm90::pack_bf16(o[4 * n + 2 * rr] * l[rr],
                          o[4 * n + 2 * rr + 1] * l[rr]);
    }
  sm90::fence_async_shared();
  sm90::named_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    for (int c = 0; c < P::BOXES; ++c)
      sm90::tma_store4(&om, Os + c * P::Q_BOX, c * 64, h, wq0, b);
    sm90::tma_store_wait();
  }
}

// (B, S, H, D) contiguous bf16 at base as a 4-D map (D, H, S, B) read in
// boxes of 64 columns x 1 head x `rows` positions x 1 batch row, with the
// 128-byte swizzle the wgmma descriptors name.  S is a dimension of its
// own, so a box past a sequence's end reads zeros (and a store past it
// writes nothing), never the next batch row.
bool map_bshd(CUtensorMap* map, const void* base, int B, int S, int H,
              int D, int rows) {
  const sm90::EncodeTiled encode = sm90::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, stride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  using P = Sm90<D>;
  CUtensorMap qm, km, vm, om;
  if (!map_bshd(&qm, q, B, Sq, Hq, D, P::WQ)
      || !map_bshd(&km, k, B, Skv, Hkv, D, P::BK)
      || !map_bshd(&vm, v, B, Skv, Hkv, D, P::BK)
      || !map_bshd(&om, o, B, Sq, Hq, D, P::WQ))
    return (int)cudaErrorNotSupported;
  static unsigned done = 0;
  cudaError_t err = sm90::set_smem_once(flash_sm90<D>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, B, (Sq + P::BQ - 1) / P::BQ);
  flash_sm90<D><<<grid, P::THREADS, P::SMEM, stream>>>(
      qm, km, vm, om, Sq, Skv, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

// The kernel a call takes, by dtype code and head size alone
// (kernels/flash_attention.py::kernel_for names the same).
enum Route { FLASH_KERNEL = 0, FLASH_MMA = 1, FLASH_SM90 = 2 };
constexpr int route(int dtype, int D) {
  return dtype == 0 ? FLASH_KERNEL
                    : (D == 64 || D == 128 ? FLASH_SM90 : FLASH_MMA);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int r = route(std::is_same<T, float>::value ? 0 : 1, D);
  if constexpr (r == FLASH_SM90) {
    return launch_sm90<D>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                          scale, stream);
  } else if constexpr (r == FLASH_MMA) {
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

// The kernel flash_attention_fwd takes for (dtype, D): 0 flash_kernel,
// 1 flash_mma, 2 flash_sm90; -1 for a pair it does not take.
int flash_attention_route(int dtype, int D) {
  if ((dtype != 0 && dtype != 1)
      || (D != 16 && D != 32 && D != 64 && D != 80 && D != 128 && D != 256))
    return -1;
  return route(dtype, D);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
