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
// Four kernels, chosen by the dtype and the head size alone (route()):
// * bfloat16 at D = 64, 80, 128 and 256 (every served model's heads:
//   the transformers' 64 and 128, hubert-xlarge's 80, recurrentgemma-9b's
//   local layers' 256): flash_sm90, the TMA ring and warp-specialised
//   wgmma.  One block owns one (b, q-head, 128-query tile): two consumer
//   warpgroups of 64 query rows and a producer warpgroup (setmaxnreg: 24
//   registers a producer thread, 240 a consumer one).  One producer
//   thread keeps a ring of K and V tiles full with TMA boxes, each tile
//   on a full mbarrier of its own, each stage freed by an empty mbarrier
//   every consumer thread arrives on; q, k, v and o are 4-D tensor maps
//   (D, H, S, B), so rows past a sequence, and columns past D, read zeros
//   and stores past them write nothing.  S = Q.K^T is wgmma m64nBKk16
//   from shared memory (both operands K-major), the scale and the online
//   softmax in f32 registers (partial maxima and sums a row, quads
//   reduced with shuffles, ex2.approx), P split in registers into bf16
//   hi and lo, the A operands of two wgmma for O += P.V (V read
//   MN-major), O in f32 registers.  Building with
//   -DFLASH_SM90_P_PIECES=1 keeps one bf16 P and one P.V product a tile,
//   as FA3 and the library call do; it is faster but brings llama3.2-3b's
//   served logits close to their 2e-2 limit, so the served build keeps
//   two pieces (PERF.md §6).  A warpgroup issues tile t's S and tile
//   t - 1's P.V together; the two warpgroups take turns to issue (named
//   barriers), so one's softmax runs under the other's products.  A tile
//   of at most 64 query rows (a prompt that short, or a prompt's last
//   tile) runs on one warpgroup.  The output leaves through the
//   warpgroup's Q rows as a TMA store.  The q tile is the slowest grid
//   index, so causal prefills hand out every head's heaviest tile first.
//   The tiles by head size (Sm90<D>):
//   - D = 64 and 128: 128-key tiles (4 and 3 stages) in boxes of 64
//     columns under the 128-byte swizzle; S at n = 128, P.V at n = D.
//   - D = 80: a row is 160 bytes, past the 128-byte swizzle's 64
//     columns, so the boxes are 32 columns under the 64-byte swizzle,
//     three of them, the third reading columns 64-95 with TMA's zeros
//     past 80: the kernel reads the (B, S, H, 80) tensors where they
//     are, with no padding copy.  Q.K^T stops at k = 80 (its fifth k
//     step reads the first half of the third box's rows); P.V runs as
//     m64n80k16, reading that box in part (at n = 96, the whole box, it
//     would run 1.2x the products).
//     128-key tiles, 4 stages (216 KB).  hubert-xlarge's 16 heads x 8 q
//     tiles are 128 blocks, one wave of 8 kv tiles each.
//   - D = 256: O alone takes 128 registers a consumer thread, so the kv
//     tile is 64 keys (S 32 registers, P's two pieces 32 more, and the
//     softmax keeps two partial maxima and sums a row, not four); Q
//     takes 64 KB, a K or V tile 32 KB, so the ring has 2 stages (192
//     KB).  S is m64n64k16 (its operands read at the shared-memory
//     port's 128 bytes a clock), P.V two m64n128k16 a piece into O's
//     halves.  The descriptors of Q, K and V are taken anew in each turn
//     (opaque) and stepped by adding to their start-address field:
//     hoisted out of the loop they held registers enough to spill.
//   What bounds it: at S 1024 the causal tail of a 1.5-4 wave grid; at
//   S 4096 the tensor cores (P.V twice over, for P's two halves) and the
//   softmax's exponentials (16 a clock an SM: a 128 x 128 tile's take
//   about half as long as its products at D = 128).  At D = 256 under
//   recurrentgemma-9b's MQA every block streams its whole kv range of the
//   one kv head from L2 (~348 MB of tiles at 2300 tokens for 16 q heads):
//   a copy of this kernel with both products taken out (the ring and the
//   softmax alone; its output is wrong, it was timed once, PERF.md §6)
//   takes about half the served time, so L2 serves the shared head but
//   its stream, not the tensor cores, sets the floor;
//   two q heads of the kv head sharing each tile by TMA multicast in a
//   2-block cluster was tried and ran slower (the pair's stages refill
//   in lockstep).  At D = 80 the same copy takes over four fifths of
//   the served time: a one-wave grid's ring fill, softmax and launch.
// * bfloat16 at D = 16 and 32 (the reduced configs): flash_mma, FA2-
//   style mma.sync.  One block owns one (b, q-head, 64-query tile) and 4
//   warps, each warp 16 query rows.  Q comes in once (A fragments kept
//   in registers); K/V tiles arrive in shared memory as bf16 through a
//   two-stage ring of 16-byte cp.async copies (kv rows past Skv
//   zero-filled, never loaded), rows padded by 8 elements so ldmatrix
//   has no bank conflicts.  S = Q.K^T runs as mma.sync.m16n8k16 into f32
//   registers, the scale is applied to S in f32, the online softmax
//   stays in registers (each row's max and sum reduced across its quad
//   with shuffles), P is split in registers into bf16 hi = bf16(p) and
//   lo = bf16(p - hi), A fragments of two mma for O += P.V (V by
//   ldmatrix.trans), O in f32 registers; the kv tile is 64 keys.  Masks
//   are evaluated only on tiles that cut the diagonal, the window edge
//   or the kv tail.  Under a causal mask the q tiles with the most live
//   kv tiles launch first (blockIdx.x reversed).
// * float32 at D = 64, 80, 128 and 256 (every head size of a full-width
//   model: the characterization's groups, every float32 check of a
//   served model, hubert-xlarge's encoder, recurrentgemma-9b's local
//   layers): flash_sm90_f32, three TF32 products on wgmma.  What bounds
//   it: the CUDA cores give 67 TFLOP/s of
//   float32, the tensor cores 495 of TF32, and float32 products come from
//   them as a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (~2^-21 of |a||b|;
//   a_hi.b_hi alone, ~2^-11, misses the reference's 2e-5 by ~50x).  At
//   the characterization's B 2, S 256, 32/32 heads of 64 that is 0.0033
//   ms of products against 0.0050 ms of q, k, v and o at 3.35 TB/s (the
//   CUDA cores would need 0.0080), so the bound is the bytes.  The
//   pieces: hi = x rounded to TF32 to nearest (two integer operations),
//   lo = x - hi, exact, passed as it is: the tensor cores read a float32
//   operand as its top 19 bits (a card test shows builds that clear the
//   low 13 and that do not agree bit for bit), an error of either sign
//   in lo.  Passing x itself as hi (read truncated, lo = x - trunc(x))
//   was as fast but errs toward zero in every piece: 1.3-1.9x the error
//   against a float64 reference.  tests/test_torch_flash_sm90_f32.py
//   repeats the served arithmetic in plain PyTorch.  TF32
//   wgmma takes both operands K-major only (the transpose bits are for
//   16-bit types), so V is staged transposed, keys contiguous, and in
//   each 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7: a thread's
//   score accumulator holds columns 2t and 2t + 1 of each 8-key block
//   where the TF32 A fragment wants k indices t and t + 4, so P goes from
//   the accumulator to the A operand without a shuffle (a build in plain
//   order, -DFLASH_SM90_F32_PLAIN_V=1, fails its check).  One block owns
//   one (b, q-head, 128-query tile): two consumer warpgroups of 64 rows
//   and a producer warpgroup (setmaxnreg 136 or 128 / 184).  The producer
//   loads each K and V tile with 16-byte loads into registers (rows past
//   Skv zeros), makes the lo pieces and stores K's hi and lo as they are
//   and V's transposed, both in the 128-byte swizzle the descriptors name
//   (32 floats a row), on full and empty mbarriers: no TMA, since every
//   tile passes through registers for its lo piece and V's transpose,
//   and a TMA landing would add a shared-memory round trip.  Each
//   consumer warpgroup scales its own Q rows once and stores them with
//   their lo pieces.  Tiles within the 227 KB: 64 keys at D = 64 (two K
//   and two V stages, 192 KB), 32 keys at D = 128 (Q's hi and lo take
//   128 KB; two K stages and one V stage, 224 KB); K runs a tile ahead of
//   V, as a turn issues tile t's S with tile t - 1's P.V and then waits.
//   S = Q.K^T is wgmma m64nBKk8 from shared memory (three products a k
//   step), the online softmax in f32 registers (ex2.approx), P and its lo
//   piece as TF32 A fragments in registers.  P.V runs as m64n64k8
//   products (three a k step) into a fresh accumulator, 64 columns of O
//   at a time, each added to O in f32 registers: the tensor cores' adds
//   do not round to nearest, and O accumulated in place drifted with the
//   prefill's length, past the reference's 2e-5 at 2048-4096 tokens.  O
//   is stored straight to global memory.  The warpgroups take turns at
//   the tensor cores as in flash_sm90, and the first and last turns are
//   peeled.  What holds it back: a turn holds the softmax and a wait for
//   the producer beside its products, and the S = Q.K^T products from
//   shared memory at n = 64 or 32 read 3-4 KB a wgmma, about what the
//   shared-memory port gives at the TF32 rate.  The tiles by head size
//   (Sm90F32<D>), where D = 80 and 256 differ:
//   - D = 80: a row is 2.5 boxes of 32 floats, so Q and K take three,
//     their columns 80-95 never written and never read (Q.K^T stops at k
//     = 80, ten k steps); V^T is 80 rows of 32 keys and P.V one m64n80k8
//     product a piece, no padding copy.  32-key tiles, two K and two V^T
//     stages (Q's pieces 96 KB, a K tile 24 KB, a V^T tile 20 KB: 185 KB
//     with the ring).  The producer holds two K and two V tiles in
//     registers (setmaxnreg 160, the consumers 168), so a tile's loads
//     are in flight while the last one is split and stored: 10% faster
//     than one.  hubert-xlarge's 16 heads x 8 q tiles are 128 blocks, one
//     wave of 32 tiles each, so nothing hides the first tile's load and
//     split.  What bounds it, measured with copies of this kernel built
//     without the products and without the producer's stores (PERF.md
//     §6): each takes over four fifths of the served time, so the
//     producer's staging and the products each nearly fill it.
//   - D = 256: Q's pieces for 128 rows would take 256 KB, so a block owns
//     64 query rows on one consumer warpgroup (Q's pieces 128 KB, O 128
//     registers a thread).  16-key tiles (a K tile 32 KB, a V^T tile 32
//     KB, V^T in 64-byte rows of 16 keys under the 64-byte swizzle), two
//     K stages and one V^T stage (224 KB).  S is m64n16k8 from shared
//     memory (96 products a tile); P.V is four m64n64k8 products a piece,
//     one 64-column pv at a time.  With no second warpgroup to take
//     turns with, a tile's S goes in four parts, each queued behind one
//     of P.V's parts, so the tensor cores run S while a part's pv is
//     added to O.  The 256 threads may hold 255 registers each (the
//     consumer takes ~250), so the producer holds two tiles as at D = 80
//     without setmaxnreg.  What bounds it, measured as at D = 80: the copy
//     without the products takes seven tenths of the served time, the
//     copy without the producer's stores four fifths; they share the
//     shared-memory port (S at n = 16 reads 2.5 KB a wgmma; the producer
//     writes 64 KB of pieces a tile), and a copy that also skips the
//     producer's loads was no faster than one without its stores, so the
//     L2 stream of the one kv head is not what bounds it.  Tried and
//     dropped: Q stored once in float32 with its A fragments loaded
//     (ldmatrix) and split in registers at each k step (the register
//     form of TF32 wgmma), which halves Q's shared memory and S's reads
//     but must wait on the fragments in flight every k step: slower, and
//     it spilled at 3-4 steps in flight; one K stage with two V^T stages
//     (slower); P.V at n = 128 (no faster, 64 registers more).  Two
//     consumer warpgroups with Q stored once would leave the producer
//     under 80 registers.
// * float32 at D = 16 and 32 (the reduced configs): flash_kernel, the
//   first version, on the CUDA cores.  One block owns one (b, q-head,
//   64-query tile) and loops over kv tiles itself, with m, l and the
//   64 x D accumulator in registers.  128 threads form a 16 x 8 grid:
//   thread (ty, tx) holds query rows ty + 16i (i < 4), score columns
//   tx + 8j (j < 8) and output columns tx + 8j (j < D/8), so each row's
//   max and sum reduce over 8 neighbouring lanes with shuffles.  Q
//   (scaled in f32), the K and V tiles, and the probabilities live in
//   shared memory as f32, padded so no warp reads two rows in one bank.
// Head sizes 16 (every reduced config), 32, 64, 80 (hubert-xlarge), 128
// and 256 (recurrentgemma-9b's local layers): multiples of 16, so the
// kernels' tilings hold (the k16 step of mma and wgmma, the 16-column
// ldmatrix.trans of V).  The wrapper zero-pads any other head size up
// to the next one.
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
  static_assert(D == 16 || D == 32, "flash_mma serves head sizes 16, 32");
  static constexpr int BKV = 64;
  static constexpr int LD = D + 8;                    // padded row
  static constexpr int CH = D / 8;                    // 16 B chunks a row
  static constexpr int NS = BKV / 8;                  // score n-tiles
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
  uint32_t qa[D / 16][4];
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
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
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
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        sm90::ldmatrix_x4(kf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8)
                                  * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        sm90::mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
        sm90::mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
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
// bfloat16 at D = 64, 80, 128 and 256: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------
// P's bf16 pieces in flash_sm90's O += P.V: 2 (hi + lo, the served
// build) or 1
#ifndef FLASH_SM90_P_PIECES
#define FLASH_SM90_P_PIECES 2
#endif
static_assert(FLASH_SM90_P_PIECES == 1 || FLASH_SM90_P_PIECES == 2,
              "FLASH_SM90_P_PIECES must be 1 or 2");
constexpr bool SPLIT_P = FLASH_SM90_P_PIECES == 2;

template <int D>
struct Sm90 {
  static constexpr int BQ = 128;                  // query rows a block
  static constexpr int WQ = 64;                   // rows a consumer warpgroup
  // keys a kv tile: 64 at D = 256, where O alone takes 128 registers a
  // consumer thread (S 32 and P's two pieces 32 more fit beside it)
  static constexpr int BK = D == 256 ? 64 : 128;
  // K/V ring depth, as deep as the 227 KB allow
  static constexpr int STAGES = D == 128 ? 3 : D == 256 ? 2 : 4;
  static constexpr int THREADS = 3 * 128;         // 2 consumer warpgroups
                                                  // and the producer's
  // registers a thread after setmaxnreg, within the 384 x 168 the block
  // is launched with: 128 x 24 + 256 x 240 = 64,512
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  // columns a TMA box: 64 under the 128-byte swizzle; 32 under the 64-byte
  // one at D = 80, whose third box reads columns 64-95, TMA's zeros past
  // 80: P.V runs at n = 80 (the third box's first 16 columns) and Q.K^T
  // stops at k = 80
  static constexpr int BW = D == 80 ? 32 : 64;
  static constexpr int ROW = 2 * BW;              // bytes a box row
  static constexpr int BOXES = (D + BW - 1) / BW;
  static constexpr int DP = BOXES * BW;           // columns in shared memory
  static constexpr int ON = D == 80 ? 80 : DP;    // O's columns
  // partial maxima and sums a row in the softmax (fewer where registers
  // are short)
  static constexpr int NPART = BK == 128 ? 4 : 2;
  static constexpr int KSTEPS = D / 16;           // k16 steps of Q.K^T
  static constexpr int ATOM = 8 * ROW;            // an 8-row swizzle atom
  static constexpr int Q_BOX = BQ * ROW;          // bytes of a Q box column
  static constexpr int KV_BOX = BK * ROW;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX; // one K or one V tile
  static constexpr int BARS = 1 + 3 * STAGES;     // q, k, v full; empty
  // + 1024: the dynamic base is rounded up to the swizzle atom's boundary
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
  static_assert(D % 16 == 0 && DP >= D, "head size");
  static_assert(SMEM <= 232448, "past the 227 KB a block may use");
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x, as a value the compiler cannot compute ahead (it keeps what is
// derived from it where it is used)
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// a wgmma descriptor of the swizzle flash_sm90<D>'s boxes are laid in
template <int D>
__device__ __forceinline__ uint64_t sm90_desc(uint32_t addr, uint32_t lbo) {
  return Sm90<D>::BW == 64 ? sm90::desc_sw128(addr, lbo, Sm90<D>::ATOM)
                           : sm90::desc_sw64(addr, lbo, Sm90<D>::ATOM);
}

// 64 x n accumulators of wgmma products: S = Q.K^T at n = 64 or 128 from
// shared memory, O += P.V at n = 64, 80, 128 or 256 (two products into
// O's halves) with P from registers and V MN-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 64) sm90::wgmma_ss_n64(d, a, b, accumulate);
  else sm90::wgmma_ss_n128(d, a, b, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         uint64_t b_hi) {
  if constexpr (N == 64) {
    sm90::wgmma_rs_n64(d, a, b, 1);
  } else if constexpr (N == 80) {
    sm90::wgmma_rs_n80(d, a, b, 1);
  } else if constexpr (N == 128) {
    sm90::wgmma_rs_n128(d, a, b, 1);
  } else {
    static_assert(N == 256, "n");
    sm90::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, b, 1);
    sm90::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, b_hi,
                        1);
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90<D>::THREADS, 1)
flash_sm90(const __grid_constant__ CUtensorMap qm,
           const __grid_constant__ CUtensorMap km,
           const __grid_constant__ CUtensorMap vm,
           const __grid_constant__ CUtensorMap om, int Sq, int Skv, int Hq,
           int Hkv, int causal, int window, float scale) {
  using P = Sm90<D>;
  constexpr int BK = P::BK, ST = P::STAGES, ROW = P::ROW, ON = P::ON;
  constexpr int NP = P::NPART;
  constexpr int KPB = ROW / 32;                   // k16 steps a box row
  extern __shared__ __align__(1024) unsigned char raw_tma[];
  unsigned char* Qs =
      raw_tma + ((1024 - (sm90::smem_addr(raw_tma) & 1023)) & 1023);
  unsigned char* Ks = Qs + P::Q_BYTES;              // [ST][BOXES][BK][ROW]
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
    // Rows past Sq or Skv, and columns past D, arrive as zeros.
    if (tid == 2 * 128) {
      sm90::bar_expect(q_full, consumers * (P::Q_BYTES / 2));
      for (int c = 0; c < P::BOXES; ++c)
        for (int w = 0; w < consumers; ++w)
          sm90::tma_load4(Qs + c * P::Q_BOX + w * P::WQ * ROW, &qm, q_full,
                          c * P::BW, h, q0 + w * P::WQ, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, k0 = kv_begin + t * BK;
        if (t >= ST) sm90::bar_wait(&empty[s], ((t / ST) & 1) ^ 1);
        sm90::bar_expect(&k_full[s], P::KV_BYTES);
        for (int c = 0; c < P::BOXES; ++c)
          sm90::tma_load4(Ks + s * P::KV_BYTES + c * P::KV_BOX, &km,
                          &k_full[s], c * P::BW, hk, k0, b);
        sm90::bar_expect(&v_full[s], P::KV_BYTES);
        for (int c = 0; c < P::BOXES; ++c)
          sm90::tma_load4(Vs + s * P::KV_BYTES + c * P::KV_BOX, &vm,
                          &v_full[s], c * P::BW, hk, k0, b);
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
  const uint32_t q_addr = sm90::smem_addr(Qs) + wg * P::WQ * ROW;
  const uint32_t k_addr = sm90::smem_addr(Ks);
  const uint32_t v_addr = sm90::smem_addr(Vs);
  float o[ON / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < ON / 2; ++i) o[i] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};  // rows g, g + 8
  // P of the last tile as bf16 A fragments, hi = bf16(p), lo = bf16(p - hi)
  // (lo unused with one piece)
  uint32_t ph[BK / 16][4], pl[SPLIT_P ? BK / 16 : 1][4];
  sm90::bar_wait(q_full, 0);

  // The descriptors of this warpgroup's Q and of stage 0's K and V tiles;
  // a stage or a k step adds its bytes / 16 to the start-address field.
  // Each turn takes them anew (opaque): hoisted out of the loop, every k
  // step's would hold two registers for the whole kernel.
  const uint64_t dq0 = sm90_desc<D>(q_addr, 16);
  const uint64_t dk0 = sm90_desc<D>(k_addr, 16);
  const uint64_t dv0 = sm90_desc<D>(v_addr, P::KV_BOX);
  // O += P.V for the tile in stage sp: BK / 16 steps of m64nONk16 for
  // each of P's pieces, V read transposed (MN-major); at D = 256 two
  // m64n128k16 a piece, into O's halves (the second two boxes on)
  auto gemm_pv = [&](int sp) {
    const uint64_t dv = opaque(dv0) + sp * (P::KV_BYTES >> 4);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t d = dv + ((kk * 16 * ROW) >> 4);
      const uint64_t d_hi = d + ((2 * P::KV_BOX) >> 4);
      wgmma_rs<ON>(o, ph[kk], d, d_hi);
      if constexpr (SPLIT_P) wgmma_rs<ON>(o, pl[kk], d, d_hi);
    }
  };
  // S = Q.K^T for the tile in stage s: D / 16 steps of m64nBKk16, both
  // operands K-major (at D = 80 the fifth step reads the first half of
  // the third box's rows, the zeros past it never)
  auto gemm_s = [&](int s) {
    const uint64_t dq = opaque(dq0);
    const uint64_t dk = opaque(dk0) + s * (P::KV_BYTES >> 4);
#pragma unroll
    for (int kk = 0; kk < P::KSTEPS; ++kk) {
      const int box = kk / KPB, at = (kk % KPB) * 32;
      wgmma_ss<BK>(sc, dq + ((box * P::Q_BOX + at) >> 4),
                   dk + ((box * P::KV_BOX + at) >> 4), kk > 0);
    }
  };
  // The online softmax of tile t's scores in sc (NP partial maxima and
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
    float mx[2][NP];
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) mx[i / NP][i % NP] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i / 2][(j % (NP / 2)) * 2 + i % 2] =
            fmaxf(mx[i / 2][(j % (NP / 2)) * 2 + i % 2], sc[4 * j + i]);
    float m_new[2], al[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x = mx[rr][0];
#pragma unroll
      for (int i = 1; i < NP; ++i) x = fmaxf(x, mx[rr][i]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      // in the exp2 domain; m stays finite (>= M_INIT), so masked
      // scores give exp2(-inf) = 0
      m_new[rr] = fmaxf(m[rr], x * sl2);
      al[rr] = exp2_approx(m[rr] - m_new[rr]);
      m[rr] = m_new[rr];
    }
    float sum[2][NP] = {};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2_approx(fmaf(sc[4 * j + i], sl2, -m_new[i / 2]));
        sc[4 * j + i] = p;
        sum[i / 2][(j % (NP / 2)) * 2 + i % 2] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)    // this thread's columns; quad sum at end
      l[rr] = l[rr] * al[rr]
              + (NP == 4 ? (sum[rr][0] + sum[rr][1])
                               + (sum[rr][2 % NP] + sum[rr][3 % NP])
                         : sum[rr][0] + sum[rr][1]);
#pragma unroll
    for (int n = 0; n < ON / 8; ++n)
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
  // Q rows, laid out as the map's swizzle, then one TMA store a box (rows
  // past Sq and columns past D are not written)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
  sm90::named_sync(1 + wg, 128);      // the warpgroup's Q reads are done
  unsigned char* Os = Qs + wg * P::WQ * ROW;
  constexpr int CPR = ROW / 16;       // 16-byte chunks a box row
  const int r0 = warp * 16 + lane / 4, cb = 4 * (lane % 4);
#pragma unroll
  for (int n = 0; n < ON / 8; ++n)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      // the 16-byte chunks of row r lie at chunk ^ (r % 8) (128-byte
      // swizzle) or chunk ^ (r / 2 % 4) (64-byte)
      const int swz = CPR == 8 ? r % 8 : (r / 2) % 4;
      *reinterpret_cast<uint32_t*>(Os + (n / CPR) * P::Q_BOX + r * ROW
                                   + ((n % CPR) ^ swz) * 16 + cb) =
          sm90::pack_bf16(o[4 * n + 2 * rr] * l[rr],
                          o[4 * n + 2 * rr + 1] * l[rr]);
    }
  sm90::fence_async_shared();
  sm90::named_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    for (int c = 0; c < P::BOXES; ++c)
      sm90::tma_store4(&om, Os + c * P::Q_BOX, c * P::BW, h, wq0, b);
    sm90::tma_store_wait();
  }
}

// (B, S, H, D) contiguous bf16 at base as a 4-D map (D, H, S, B) read in
// boxes of `cols` columns x 1 head x `rows` positions x 1 batch row, with
// the swizzle the wgmma descriptors name (128-byte for 64 columns,
// 64-byte for 32).  S is a dimension of its own, so a box past a
// sequence's end reads zeros (and a store past it writes nothing), never
// the next batch row; so do columns past D.
bool map_bshd(CUtensorMap* map, const void* base, int B, int S, int H,
              int D, int rows, int cols) {
  const sm90::EncodeTiled encode = sm90::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, stride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  using P = Sm90<D>;
  CUtensorMap qm, km, vm, om;
  if (!map_bshd(&qm, q, B, Sq, Hq, D, P::WQ, P::BW)
      || !map_bshd(&km, k, B, Skv, Hkv, D, P::BK, P::BW)
      || !map_bshd(&vm, v, B, Skv, Hkv, D, P::BK, P::BW)
      || !map_bshd(&om, o, B, Sq, Hq, D, P::WQ, P::BW))
    return (int)cudaErrorNotSupported;
  static unsigned done = 0;
  cudaError_t err = sm90::set_smem_once(flash_sm90<D>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, B, (Sq + P::BQ - 1) / P::BQ);
  flash_sm90<D><<<grid, P::THREADS, P::SMEM, stream>>>(
      qm, km, vm, om, Sq, Skv, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}
// ---------------------------------------------------------------------------
// float32 at D = 64, 80, 128 and 256: three TF32 products on wgmma
// ---------------------------------------------------------------------------
// The keys of each 8-key group of a transposed V tile: 0 (served) in the
// order 0, 2, 4, 6, 1, 3, 5, 7 that P's A fragments take (sm90_tiles.cuh,
// the TF32 wgmma note); 1 in plain order, which must fail its check (a
// card test builds it)
#ifndef FLASH_SM90_F32_PLAIN_V
#define FLASH_SM90_F32_PLAIN_V 0
#endif
// The TF32 pieces of every operand (served): hi = x rounded to TF32 to
// nearest (ties away, as cvt.rna.tf32.f32 rounds, in two integer
// operations), lo = x - hi as it is (exact; the tensor cores read it as
// its top 19 bits, dropping its low 13, an error of either sign); three
// products a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  FLASH_SM90_F32_ONE_PRODUCT
// builds one product of hi alone instead, for card tests: 1 with hi = x
// as it is, 2 with hi = x with its low 13 bits cleared (the two agree
// bit for bit exactly when the tensor cores drop those bits)
#ifndef FLASH_SM90_F32_ONE_PRODUCT
#define FLASH_SM90_F32_ONE_PRODUCT 0
#endif
static_assert(FLASH_SM90_F32_ONE_PRODUCT >= 0 &&
                  FLASH_SM90_F32_ONE_PRODUCT <= 2,
              "FLASH_SM90_F32_ONE_PRODUCT must be 0-2");
constexpr bool THREE_TF32 = FLASH_SM90_F32_ONE_PRODUCT == 0;

__device__ __forceinline__ void tf32_pieces(float x, float& hi, float& lo) {
#if FLASH_SM90_F32_ONE_PRODUCT == 0
  hi = sm90::tf32_round(x);
  lo = x - hi;
#else
  hi = FLASH_SM90_F32_ONE_PRODUCT == 2 ? sm90::tf32_trunc(x) : x;
  lo = 0.f;
#endif
}

// four floats as TF32 hi and lo pieces, stored at byte `off` of each
__device__ __forceinline__ void store_pieces(unsigned char* hi_base,
                                             unsigned char* lo_base, int off,
                                             float4 x) {
  float4 h, l;
  tf32_pieces(x.x, h.x, l.x);
  tf32_pieces(x.y, h.y, l.y);
  tf32_pieces(x.z, h.z, l.z);
  tf32_pieces(x.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi_base + off) = h;
  *reinterpret_cast<float4*>(lo_base + off) = l;
}

// byte offset of 16-byte chunk c (floats 4c .. 4c + 3) of row r in a
// K-major tile of `rows` rows under the 128-byte swizzle: boxes of 32
// floats a row, one after another
__device__ __forceinline__ int sw128(int r, int c, int rows) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) * 16);
}

__device__ __forceinline__ float part(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p))
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
struct Sm90F32 {
  static_assert(D == 64 || D == 80 || D == 128 || D == 256, "head size");
  // consumer warpgroups a block, 64 query rows each: one at D = 256, where
  // Q's hi and lo pieces for 128 rows would take 256 KB
  static constexpr int WGS = D == 256 ? 1 : 2;
  static constexpr int WQ = 64;                   // rows a consumer warpgroup
  static constexpr int BQ = WGS * WQ;             // query rows a block
  static constexpr int BK = D == 64 ? 64 : D == 256 ? 16 : 32;  // keys a tile
  static constexpr int KS = 2;                    // K ring stages
  static constexpr int VS = D == 128 || D == 256 ? 1 : 2;  // V^T stages
  static constexpr int THREADS = (WGS + 1) * 128; // and the producer's
  // K and V tiles the producer holds in registers: two of each at D = 80
  // and 256, so a tile's loads are in flight while the last one is
  // stored (at D = 64 and 128 the second pair, 64 registers, would not
  // fit the producer's 128-136)
  static constexpr int LA = D == 80 || D == 256 ? 2 : 1;
  // Two consumer warpgroups take registers from the producer's by
  // setmaxnreg, within the 384 x 168 the block is launched with (64,512):
  // 128 x 136 + 256 x 184 at D = 64, 128 x 128 + 256 x 184 at D = 128 (a
  // producer of 104 spilled at both sizes, of 120 at D = 128), 128 x 160
  // + 256 x 168 at D = 80 (its two tiles).  With one (D = 256) a thread
  // may hold 255 of the 65,536 and nothing is handed over.
  static constexpr int PRODUCER_REGS = D == 64 ? 136 : D == 80 ? 160 : 128;
  static constexpr int CONSUMER_REGS = D == 80 ? 168 : 184;
  static constexpr int QB = (D + 31) / 32;        // 32-float boxes a row
  static constexpr int Q_PIECE = QB * WQ * 128;   // a warpgroup's Q hi or lo
  static constexpr int K_PIECE = QB * BK * 128;   // a K tile's hi or lo
  // V^T: D rows of the tile's keys, in rows of 32 keys (128 bytes, the
  // 128-byte swizzle), or of 16 at D = 256 (64 bytes, the 64-byte swizzle)
  static constexpr int VROW = BK >= 32 ? 128 : 64;
  static constexpr int GPR = VROW / 32;           // 8-key groups a V^T row
  static constexpr int V_PIECE = BK * D * 4;      // a V^T tile's hi or lo
  // O's columns a P.V product covers: the tile's P.V is D / PN products
  // into one fresh accumulator of PN columns
  static constexpr int PN = D == 80 ? 80 : 64;
  static constexpr int KG = BK / 8;               // 8-key groups a tile
  // one (8-key group, 4-column chunk) of V a producer thread (at D = 80,
  // 80 of them)
  static_assert(KG * (D / 4) <= 128, "V's groups x chunks > 128");
  static constexpr int KCH = BK * D / 4 / 128;    // K's chunks a thread
  static_assert(KCH * 128 == BK * D / 4, "K's chunks");
  static_assert(D % PN == 0, "P.V's products");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 64512,
                "registers");
  // + 1024: the dynamic base is rounded up to the swizzle atom's boundary
  static constexpr int SMEM = 1024 + 2 * WGS * Q_PIECE + 2 * KS * K_PIECE
                              + 2 * VS * V_PIECE + 16 * (KS + VS);
  static_assert(SMEM <= 232448, "past the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(Sm90F32<D>::THREADS, 1)
flash_sm90_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int Sq,
               int Skv, int Hq, int Hkv, int causal, int window,
               float scale) {
  using P = Sm90F32<D>;
  constexpr int BK = P::BK, KS = P::KS, VS = P::VS, PN = P::PN;
  extern __shared__ __align__(1024) unsigned char raw_f32[];
  // [hi, lo][warpgroup][QB boxes][64 rows][128 B]
  unsigned char* Qs =
      raw_f32 + ((1024 - (sm90::smem_addr(raw_f32) & 1023)) & 1023);
  // K: [KS][hi, lo][QB boxes][BK keys][128 B]; V^T: [VS][hi, lo]
  // [BK / (VROW / 4) boxes][D rows][VROW B]
  unsigned char* Ks = Qs + 2 * P::WGS * P::Q_PIECE;
  unsigned char* Vs = Ks + 2 * KS * P::K_PIECE;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(Vs + 2 * VS * P::V_PIECE);
  uint64_t* k_empty = k_full + KS;
  uint64_t* v_full = k_empty + KS;
  uint64_t* v_empty = v_full + VS;

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
  // a tile of at most 64 query rows runs on consumer warpgroup 0 alone
  const bool solo = P::WGS == 1 || Sq - q0 <= P::WQ;
  const int consumers = solo ? 1 : 2;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;

  if (tid == 0) {
    for (int s = 0; s < KS; ++s) {
      sm90::bar_init(&k_full[s], 128);              // every producer thread
      sm90::bar_init(&k_empty[s], consumers * 128); // every consumer thread
    }
    for (int s = 0; s < VS; ++s) {
      sm90::bar_init(&v_full[s], 128);
      sm90::bar_init(&v_empty[s], consumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= P::WGS * 128) {
    if constexpr (P::WGS == 2) sm90::regs_dec<P::PRODUCER_REGS>();
    // The producer warpgroup loads each K and V tile into registers,
    // makes its TF32 lo piece, and stores both pieces in the layout
    // wgmma reads: K as it is (keys by rows, D contiguous), V transposed
    // (D by rows, keys contiguous, each 8-key group in P's fragment
    // order).  Rows past Skv are zeros.  K runs one tile ahead of V, as
    // the consumers' turns take tile t's K beside tile t - 1's V.
    const int pt = tid - P::WGS * 128, lane = pt % 32;
    // this thread's V: keys 8 kg .. 8 kg + 7, columns 4 dc .. 4 dc + 3;
    // the 8 lanes of a store phase take 4 groups x 2 chunks (2 x 4 at
    // two groups a tile)
    int kg, dc;
    if constexpr (P::KG >= 4) {
      const int rest = (lane >> 3) | ((pt / 32) << 2);      // 0 .. 15
      kg = (lane & 3) + 4 * (rest % (P::KG / 4));
      dc = ((lane >> 2) & 1) + 2 * (rest / (P::KG / 4));
    } else {
      kg = lane & 1;
      dc = (lane >> 1) + 16 * (pt / 32);
    }
    // (known at compile time where every thread has a unit: tested at run
    // time at D = 64 and 128, it cost their rows 4-10%)
    const bool has_v = P::KG * (D / 4) == 128 || dc < D / 4;
    const float* kb = k + (size_t)b * Skv * kv_stride + (size_t)hk * D;
    const float* vb = v + (size_t)b * Skv * kv_stride + (size_t)hk * D;
    // the tiles in registers: one K and one V, or two of each (LA = 2),
    // so each tile's loads are in flight a whole tile ahead of its stores
    float4 kr[P::LA][P::KCH], vr[P::LA][8];
    auto load_k = [&](int t, float4 (&r)[P::KCH]) {
      const int k0 = kv_begin + t * BK;
#pragma unroll
      for (int j = 0; j < P::KCH; ++j) {
        const int i = pt + 128 * j, row = i / (D / 4), c = i % (D / 4);
        r[j] = load4(kb + (size_t)(k0 + row) * kv_stride + 4 * c,
                     k0 + row < Skv);
      }
    };
    auto load_v = [&](int t, float4 (&r)[8]) {
      const int k0 = kv_begin + t * BK + 8 * kg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = load4(vb + (size_t)(k0 + j) * kv_stride + 4 * dc,
                     has_v && k0 + j < Skv);
    };
    auto put_k = [&](int t, const float4 (&kr)[P::KCH]) {
      const int s = t % KS;
      if (t >= KS) sm90::bar_wait(&k_empty[s], ((t / KS) & 1) ^ 1);
      unsigned char* kh = Ks + s * 2 * P::K_PIECE;
#pragma unroll
      for (int j = 0; j < P::KCH; ++j) {
        const int i = pt + 128 * j;
        store_pieces(kh, kh + P::K_PIECE, sw128(i / (D / 4), i % (D / 4),
                                                BK), kr[j]);
      }
      sm90::fence_async_shared();     // visible to wgmma (the async proxy)
      sm90::bar_arrive(&k_full[s]);
    };
    auto put_v = [&](int t, const float4 (&vr)[8]) {
      const int s = t % VS;
      if (t >= VS) sm90::bar_wait(&v_empty[s], ((t / VS) & 1) ^ 1);
      unsigned char* vh = Vs + s * 2 * P::V_PIECE;
      if (has_v) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * dc + e;
          // row d's 16-byte chunks lie at chunk ^ (d % 8) (128-byte
          // swizzle) or chunk ^ (d / 2 % 4) (64-byte)
          const int swz = P::VROW == 128 ? d % 8 : (d / 2) % 4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            // chunk `half` of the group: its keys 0, 2, 4, 6 or 1, 3, 5, 7
            const int a = FLASH_SM90_F32_PLAIN_V ? 4 * half : half;
            const int st = FLASH_SM90_F32_PLAIN_V ? 1 : 2;
            const float4 x = make_float4(
                part(vr[a], e), part(vr[a + st], e),
                part(vr[a + 2 * st], e), part(vr[a + 3 * st], e));
            store_pieces(vh, vh + P::V_PIECE,
                         (kg / P::GPR) * D * P::VROW + d * P::VROW
                             + (((2 * (kg % P::GPR) + half) ^ swz) * 16),
                         x);
          }
        }
      }
      sm90::fence_async_shared();
      sm90::bar_arrive(&v_full[s]);
    };
    if constexpr (P::LA == 2) {
      // K(t) in kr[t % 2], V(t) in vr[t % 2]; a step issues the loads of
      // K(t + 2) and V(t + 1), then stores K(t + 1) and V(t), loaded a
      // step before
      load_k(0, kr[0]);
      if (nt > 1) load_k(1, kr[1]);
      load_v(0, vr[0]);
      put_k(0, kr[0]);
      auto step = [&](int t, auto parity) {
        constexpr int a = decltype(parity)::value;
        if (t + 2 < nt) load_k(t + 2, kr[a]);
        if (t + 1 < nt) load_v(t + 1, vr[a ^ 1]);
        if (t + 1 < nt) put_k(t + 1, kr[a ^ 1]);
        put_v(t, vr[a]);
      };
      for (int t = 0; t < nt; t += 2) {
        step(t, std::integral_constant<int, 0>());
        if (t + 1 < nt) step(t + 1, std::integral_constant<int, 1>());
      }
    } else {
      load_k(0, kr[0]);
      put_k(0, kr[0]);
      if (nt > 1) load_k(1, kr[0]);
      load_v(0, vr[0]);
      for (int t = 0; t < nt; ++t) {
        if (t + 1 < nt) put_k(t + 1, kr[0]);
        put_v(t, vr[0]);
        // the next tiles' loads in flight while this thread waits for
        // slots
        if (t + 2 < nt) load_k(t + 2, kr[0]);
        if (t + 1 < nt) load_v(t + 1, vr[0]);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, warp `warp` rows 16 warp + g and
  // + 8 of them (g = lane / 4), the layout of every accumulator below.
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  if (wg >= consumers) return;
  if constexpr (P::WGS == 2) sm90::regs_inc<P::CONSUMER_REGS>();
  const int wq0 = q0 + wg * P::WQ;
  const int w_first = wq0 + off;                    // its positions
  const int w_last = min(wq0 + P::WQ, Sq) - 1 + off;
  const int qp0 = w_first + warp * 16 + lane / 4;   // row g's position

  // Q: the warpgroup's rows scaled in f32 (flash_attention.py:44), stored
  // with their TF32 lo pieces; rows past Sq are zeros (at D = 80 the
  // third box's columns 80-95 are never written, and never read)
  unsigned char* qh = Qs + wg * P::Q_PIECE;
  unsigned char* ql = Qs + (P::WGS + wg) * P::Q_PIECE;
  const float* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = wt; i < P::WQ * D / 4; i += 128) {
    const int r = i / (D / 4), c = i % (D / 4), s = wq0 + r;
    float4 x = load4(qb + (size_t)s * q_stride + 4 * c, s < Sq);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    store_pieces(qh, ql, sw128(r, c, P::WQ), x);
  }
  sm90::fence_async_shared();
  sm90::named_sync(1 + wg, 128);

  const uint32_t k_addr = sm90::smem_addr(Ks), v_addr = sm90::smem_addr(Vs);
  // O in f32 registers.  Each turn's P.V lands in pv first, PN columns at
  // a time, then is added to O in f32: accumulated in place by the tensor
  // cores, whose adds do not round to nearest, O drifted with the
  // prefill's length
  float o_acc[D / 2], pv[PN / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};  // rows g, g + 8
  // P of the last tile as TF32 A fragments, hi and lo (lo unused with one
  // piece): k step kk is keys 8 kk .. 8 kk + 7
  uint32_t ph[BK / 8][4], pl[THREE_TF32 ? BK / 8 : 1][4];

  // Descriptors of a piece's first k step; a k step adds its byte offset
  // / 16 to the start-address field (shared addresses stay below 256 KB,
  // so the field never carries)
  auto desc = [](uint32_t addr) { return sm90::desc_sw128(addr, 16, 1024); };
  auto vdesc = [](uint32_t addr) {
    return P::VROW == 128 ? sm90::desc_sw128(addr, 16, 1024)
                          : sm90::desc_sw64(addr, 16, 512);
  };
  const uint64_t dqh = desc(sm90::smem_addr(qh));
  const uint64_t dql = desc(sm90::smem_addr(ql));
  // d = S = Q.K^T for the K tile in slot s: D / 8 steps of m64nBKk8,
  // three products each (the small ones first), both operands K-major
  // (at D = 80 the last two steps read the third box's first 16
  // columns); or d = part `part` of `parts` of those steps
  auto gemm_s = [&](float (&d)[BK / 2], int s, int part = 0,
                    int parts = 1) {
    // Q's descriptors anew in each turn: hoisted out of the loop, each k
    // step's would hold two registers for the whole kernel
    const uint64_t qh_d = opaque(dqh), ql_d = opaque(dql);
    const uint64_t dkh = desc(k_addr + s * 2 * P::K_PIECE);
    const uint64_t dkl = dkh + P::K_PIECE / 16;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      if (kk * parts / (D / 8) != part) continue;
      const int first = kk == part * (D / 8) / parts;
      const uint32_t oq = ((kk / 4) * P::WQ * 128 + (kk % 4) * 32) / 16;
      const uint32_t ok = ((kk / 4) * BK * 128 + (kk % 4) * 32) / 16;
      auto mma = [&](uint64_t a, uint64_t bb, int acc) {
        if constexpr (BK == 64)
          sm90::wgmma_tf32_ss_n64(d, a, bb, acc);
        else if constexpr (BK == 32)
          sm90::wgmma_tf32_ss_n32(d, a, bb, acc);
        else
          sm90::wgmma_tf32_ss_n16(d, a, bb, acc);
      };
      if constexpr (THREE_TF32) {
        mma(ql_d + oq, dkh + ok, !first);
        mma(qh_d + oq, dkl + ok, 1);
        mma(qh_d + oq, dkh + ok, 1);
      } else {
        mma(qh_d + oq, dkh + ok, !first);
      }
    }
  };
  // pv = P.V for O's columns PN h .. PN h + PN - 1 from the V^T tile in
  // slot s: BK / 8 steps of m64nPNk8, three products each, P from
  // registers, V^T K-major (its rows are O's columns)
  auto gemm_pv = [&](int s, int h) {
    const uint64_t dvh =
        vdesc(v_addr + s * 2 * P::V_PIECE) + h * PN * P::VROW / 16;
    const uint64_t dvl = dvh + P::V_PIECE / 16;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t ov =
          ((kk / P::GPR) * D * P::VROW + (kk % P::GPR) * 32) / 16;
      auto mma = [&](const uint32_t(&a)[4], uint64_t bb, int acc) {
        if constexpr (PN == 64)
          sm90::wgmma_tf32_rs_n64(pv, a, bb, acc);
        else
          sm90::wgmma_tf32_rs_n80(pv, a, bb, acc);
      };
      if constexpr (THREE_TF32) {
        mma(pl[kk], dvh + ov, kk > 0);
        mma(ph[kk], dvl + ov, 1);
        mma(ph[kk], dvh + ov, 1);
      } else {
        mma(ph[kk], dvh + ov, kk > 0);
      }
    }
  };
  // O's columns PN h .. PN h + PN - 1 += pv, in f32
  auto add_pv = [&](int h) {
#pragma unroll
    for (int i = 0; i < PN / 2; ++i) o_acc[PN / 2 * h + i] += pv[i];
  };
  // The online softmax of tile t's scores in sc (scaled already: the
  // scale went into Q), O rescaled, and P as TF32 A fragments: the
  // accumulator's {4j, 4j + 2, 4j + 1, 4j + 3} for k step j
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
    float mx[2][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i / 2][i % 2] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i / 2][j % 2] = fmaxf(mx[i / 2][j % 2], sc[4 * j + i]);
    float m_new[2], al[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x = fmaxf(mx[rr][0], mx[rr][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      // in the exp2 domain; m stays finite (>= M_INIT), so masked
      // scores give exp2(-inf) = 0
      m_new[rr] = fmaxf(m[rr], x * LOG2E);
      al[rr] = exp2_approx(m[rr] - m_new[rr]);
      m[rr] = m_new[rr];
    }
    float sum[2][2] = {};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            exp2_approx(fmaf(sc[4 * j + i], LOG2E, -m_new[i / 2]));
        sc[4 * j + i] = p;
        sum[i / 2][j % 2] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)    // this thread's columns; quad sum at end
      l[rr] = l[rr] * al[rr] + (sum[rr][0] + sum[rr][1]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[4 * n + i] *= al[i / 2];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float hi, lo;
        tf32_pieces(sc[4 * kk + (i % 2) * 2 + i / 2], hi, lo);
        ph[kk][i] = __float_as_uint(hi);
        if constexpr (THREE_TF32) pl[kk][i] = __float_as_uint(lo);
      }
  };

  // Ping-pong, as in flash_sm90: the warpgroups take turns at the tensor
  // cores (named barriers TURN + wg), so one's softmax runs while the
  // other's products do.  A turn issues tile t's S = Q.K^T and tile
  // t - 1's O += P.V together, then waits; the softmax of tile t follows
  // outside the turn.  Warpgroup 0 goes first; warpgroup 1 skips the
  // hand-over after its last turn; a warpgroup alone (every block at D =
  // 256) takes no turns.  The first and last turns are peeled off, so
  // every wgmma is issued on a path the whole warpgroup takes.
  constexpr int TURN = 3;
  const int mine = TURN + wg, other = TURN + 1 - wg;
  auto take_turn = [&] { if (!solo) sm90::named_sync(mine, 256); };
  auto pass_turn = [&] { if (!solo) sm90::named_arrive(other, 256); };
  // O's other columns (D = 128; D = 256's last tile) take products of
  // their own after the turn's wait, PN columns at a time into the same
  // pv
  auto rest_pv = [&](int sp) {
#pragma unroll
    for (int c = 1; c < D / PN; ++c) {
      sm90::wgmma_fence();
      gemm_pv(sp, c);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(pv);
      add_pv(c);
    }
  };
  // One warpgroup (D = 256) takes no turns, and its tensor cores would
  // idle while each 64 columns of P.V are added to O: so tile t's S =
  // Q.K^T goes in four parts of eight k steps, part c + 1 queued behind
  // P.V's part c (V's wait after S's first part), and the tensor cores
  // run it while part c's pv is added.  Each part of S lands in a fresh
  // accumulator (sc, sa, sb, sa), summed into sc in f32: accumulated
  // across all 32 k steps the tensor cores' adds, which do not round to
  // nearest, missed 2e-5 at 2300 tokens with q scaled by 4.
  float sa[P::WGS == 1 ? BK / 2 : 1], sb[P::WGS == 1 ? BK / 2 : 1];
  auto add_s = [&](const float (&part)[BK / 2]) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] += part[i];
  };
  // tile t's S in slot s, with tile t - 1's P.V from V^T slot sp (phase
  // vph) unless t is 0
  auto solo_turn = [&](int s, bool with_pv, int sp, int vph) {
    if constexpr (P::WGS == 1) {
      auto pv_part = [&](int c) {       // P.V's part c - 1 is done
        if (!with_pv) return;
        if (c > 0) {
          sm90::fence_regs(pv);
          add_pv(c - 1);
        }
        sm90::wgmma_fence();
        gemm_pv(sp, c);
        sm90::wgmma_commit();
      };
      sm90::wgmma_fence();
      gemm_s(sc, s, 0, 4);
      sm90::wgmma_commit();
      if (with_pv) sm90::bar_wait(&v_full[sp], vph);
      pv_part(0);
      sm90::wgmma_fence();
      gemm_s(sa, s, 1, 4);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      pv_part(1);
      sm90::wgmma_fence();
      gemm_s(sb, s, 2, 4);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      sm90::fence_regs(sa);
      add_s(sa);
      pv_part(2);
      sm90::wgmma_fence();
      gemm_s(sa, s, 3, 4);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sb);
      add_s(sb);
      pv_part(3);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sa);
      add_s(sa);
      if (with_pv) {
        sm90::fence_regs(pv);
        add_pv(3);
      }
    }
  };
  if (wg == 1) sm90::named_arrive(TURN, 256);
  sm90::bar_wait(&k_full[0], 0);
  if constexpr (P::WGS == 1) {
    solo_turn(0, false, 0, 0);
  } else {
    take_turn();
    sm90::wgmma_fence();
    gemm_s(sc, 0);
    sm90::wgmma_commit();
    pass_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
  }
  sm90::bar_arrive(&k_empty[0]);
  softmax(0);
  for (int t = 1; t < nt; ++t) {
    const int s = t % KS, sp = (t - 1) % VS;
    sm90::bar_wait(&k_full[s], (t / KS) & 1);
    if constexpr (P::WGS == 1) {
      solo_turn(s, true, sp, ((t - 1) / VS) & 1);
      sm90::bar_arrive(&k_empty[s]);
    } else {
      sm90::bar_wait(&v_full[sp], ((t - 1) / VS) & 1);
      take_turn();
      sm90::wgmma_fence();
      gemm_s(sc, s);
      gemm_pv(sp, 0);
      sm90::wgmma_commit();
      pass_turn();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(pv);
      add_pv(0);
      sm90::bar_arrive(&k_empty[s]);  // this thread is done with K
      rest_pv(sp);
    }
    sm90::fence_regs(ph);
    sm90::fence_regs(pl);
    sm90::bar_arrive(&v_empty[sp]);   // and with V
    softmax(t);
  }
  const int sp = (nt - 1) % VS;
  sm90::bar_wait(&v_full[sp], ((nt - 1) / VS) & 1);
  take_turn();
  sm90::wgmma_fence();
  gemm_pv(sp, 0);
  sm90::wgmma_commit();
  if (wg == 0) pass_turn();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(pv);
  add_pv(0);
  rest_pv(sp);
  sm90::fence_regs(ph);
  sm90::fence_regs(pl);

  // out = acc / max(l, 1e-30) (flash_attention.py:88); rows past Sq are
  // not written
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = fmaxf(l[rr], 1e-30f);
  }
  float* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D
              + 2 * (lane % 4);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = wq0 + warp * 16 + lane / 4 + 8 * rr;
    if (s >= Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(ob + (size_t)s * q_stride + 8 * n) =
          make_float2(o_acc[4 * n + 2 * rr] / l[rr],
                      o_acc[4 * n + 2 * rr + 1] / l[rr]);
  }
}

template <int D>
int launch_sm90_f32(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                    int window, float scale, cudaStream_t stream) {
  using P = Sm90F32<D>;
  static unsigned done = 0;
  cudaError_t err = sm90::set_smem_once(flash_sm90_f32<D>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, B, (Sq + P::BQ - 1) / P::BQ);
  flash_sm90_f32<D><<<grid, P::THREADS, P::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, Hq,
      Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

// The kernel a call takes, by dtype code and head size alone
// (kernels/flash_attention.py::kernel_for names the same).
enum Route {
  FLASH_KERNEL = 0, FLASH_MMA = 1, FLASH_SM90 = 2, FLASH_SM90_F32 = 3
};
constexpr int route(int dtype, int D) {
  return D == 16 || D == 32 ? (dtype == 0 ? FLASH_KERNEL : FLASH_MMA)
                            : (dtype == 0 ? FLASH_SM90_F32 : FLASH_SM90);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int r = route(std::is_same<T, float>::value ? 0 : 1, D);
  if constexpr (r == FLASH_SM90_F32) {
    return launch_sm90_f32<D>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,
                              window, scale, stream);
  } else if constexpr (r == FLASH_SM90) {
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
// 1 flash_mma, 2 flash_sm90, 3 flash_sm90_f32; -1 for a pair it does not
// take.
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
