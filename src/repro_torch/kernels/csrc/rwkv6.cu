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
// Dv) in v's type.  Any T >= 1 and any D, Dv <= 64.
//
// Three kernels.  A prefill (T > 1) runs the chunked scan,
// rwkv6_chunked_bf16 / rwkv6_chunked_f32 (form 1).  A decode step (T = 1)
// runs rwkv6_decode, and form 0 runs rwkv6_prefill, the sequential design
// this file had before: both repeat kernels/rwkv6.py::rwkv6_torch bit for
// bit (every product and sum rounded on its own, no FMA contraction, y's
// terms summed by halving in the plain version's order); the sequential
// prefill stays as the yardstick the chunked one is timed against.
//
// Work and bound: 4 D Dv FLOP per (b, t, h), the function's own (r^T S and
// the rank-1 update), 1.05 GFLOP at a prefill of B = 1, T = 1000, H = 64,
// D = Dv = 64; that fits the bf16 tensor cores in ~1 us, so the 43 MB of
// r, k, v, w, y and both states bound the function (12.9 us at 3.35
// TB/s).  The sequential prefill spends 7 rounded float32 operations per
// (t, i, j) on the CUDA cores instead, 1.8 G of them at that shape:
// instruction throughput, not bytes, is what it runs into.  At a decode
// step (B = 4, T = 1) the 8.4 MB of float32 state read and written bind
// (2.5 us).
//
// Chunked prefill: rwkv6_chunked_torch's algebra.  For a chunk of C = 16
// steps from state S, with P_t = w_0 ... w_{t-1} (P_C the chunk's) and
// Σ_s = w_{s+1} ... w_{C-1} = P_C / P_{s+1}:
//
//     A  = tril_strict((r ⊙ P)(k / P⁺)ᵀ) + diag(r·u·k)
//     y  = (r ⊙ P) S + A V
//     S' = diag(P_C) S + (k ⊙ Σ)ᵀ V
//
// Only the carry S -> S' is sequential (T / 16 steps a block); the rest of
// a chunk depends on its own inputs.  A chunk whose products P_{t+1} fall
// below 2^-64 on any channel (the block votes) cannot divide by them: it
// forms A from pairwise running products and k ⊙ Σ from products taken
// from the top, on the CUDA cores (``unfactorised``: 4 x 120 pairs of up
// to 16 channels x 14 products, ~51 K multiplies over the block's 512
// threads, and one more barrier).  rwkv6-7b's decays (~0.9975; 0.996 or 1
// in bf16) never go there: P_16 stays far above 2^-64.  Steep decays (w
// 0.01-0.05 reach 2^-64 within 12-16 steps) take it on every chunk, w = 0
// exactly on the chunks that hold it.
//
// Rounding.  bf16 inputs: the four products of a chunk (q kkᵀ, A V, q S,
// Vᵀ ks) run on the tensor cores (mma.sync m16n8k16, float32 accumulators)
// and every float32 operand (q = r ⊙ P, kk = k / P, ks = k ⊙ Σ, A and S)
// enters as three bf16 pieces (x0 = bf16(x), x1 = bf16(x - x0), x2 =
// bf16(x - x0 - x1): 24 bits, a float32 significand).  A product of two
// such operands takes the six piece products down to 2^-16 of the leading
// one (x0 y0, x0 y1, x1 y0, x0 y2, x1 y1, x2 y0: 6 mma), one with V (bf16
// already, exact) three.  Two pieces (~16 bits, 3 and 2 mma) were tried
// first and are not enough: rwkv6-7b's bf16 residual stream amplifies a
// 2^-16 operand error further than any float32 summation order, and phase
// 9 of chip_smoke.py, which accepts the kernel path only as far from the
// plain path as a float32 order (or the oracle) lies, refused it.  The
// state stays float32 in the accumulators.  rwkv6_chunked_torch(...,
// split=True) models this rounding; the kernel is held to it within
// TWIN_TOL and to rwkv6_torch within the reference's tolerance.  float32
// inputs: the same chunks and products in float32 on the CUDA cores
// (fmaf), no TF32.
//
// Grid.  Block (z, h, b) owns 32 columns of S and y of one head for all T:
// at B 1, H 64, Dv 64, 128 blocks, one an SM.  One block a head would
// leave half the SMs idle; the two-pass form (every chunk's state in
// parallel, then a scan over chunks) writes and reads 63 chunks x 64 heads
// x 16 KB = 66 MB of states, more than the function's 43 MB.  Splitting
// Dv costs each block of a head the chunk's decay products and its A
// again, and r, k, w are read by both from L2 (HBM once: the pair runs
// together).  A head's work never depends on H or B.
//
// A block is two teams of 8 warps, one barrier a chunk.  In the pass of
// chunk c the prep team writes chunk c - 1's y (the slices' shares summed
// in shared memory), forms chunk c + 1's tiles on the CUDA cores (warp w:
// channels 8w .. 8w + 7; lane (sg, cp) a channel pair at steps 2sg, 2sg +
// 1; P by a scan over the eight sg; q, kk, ks = kk P_C and the slice's
// share of diag(r u k), each stored as three bf16 pieces), asks for chunk
// c + 7 and waits for chunk c + 2 (a ring of 8 stages of 16-byte
// cp.async pieces, one a thread, their addresses worked out once); the
// products team (warp w: slice w % 4 of 16 channels, columns 16 (w / 4)
// .. + 15) runs chunk c's products: A_w over its slice (12 mma), masked
// to s < t plus its slice's diagonal, Y_w = q S_w + A_w V (12 + 6 mma),
// Sᵀ_w = P_C Sᵀ_w + Vᵀ ks (6 mma), the three chains independent until
// A_w V.  The barrier publishes the tiles,
// the shares of y and the landing of chunk c + 2, and ANDs chunk c + 1's
// vote.  Each chunk is a fixed 36 mma a warp and ~40 CUDA-core
// operations per (t, channel); its barrier, the ring's waits and the
// shared-memory traffic of both teams (the tiles' stores and ldmatrix
// reads, the shares of y) add up rather than overlap: the kernel runs at
// a fraction of both the tensor cores' rate and the bytes' (PERF.md has
// the times).  Steps past T in the last chunk carry r = k = v = 0 and w =
// 1 and write no y.
//
// Sequential prefill (form 0): rwkv6_prefill.  The columns of S evolve
// independently, and within a column the halving sum splits by channel
// residue: sixteen lanes own a column, lane c the channels c, c + 16, c +
// 32, c + 48, and each thread two columns (the step's r, k, w serve both).
// A thread sums its 4 terms of a column in registers (the levels h = 32,
// 16 pair its own channels); the levels h = 8, 4, 2, 1 pair lanes c and c
// ^ h, and run once a chunk of 16 steps for all of them together: at each
// level a lane keeps half the steps, adds its partner's share of those and
// hands over its own share of the rest (15 shuffles a column per chunk,
// not 64), so lane c ends with step c, summed in the plain version's
// order.  Block (h, b, z) owns columns 16z .. 16z + 15 with 128 threads,
// 256 blocks at B = 1, H = 64, Dv = 64.  Each chunk's r, k, w (converted
// to float32, residue-major so a lane's 4 channels are one 16-byte read)
// and its v columns are staged in shared memory, two chunks in flight.
//
// Decode (T == 1): rwkv6_decode.  There is no recurrence, only a read-
// modify-write of the state: one block of 256 threads per (b, h), thread
// (q, c) owning columns 4q .. 4q + 3 of rows c, c + 16, c + 32, c + 48,
// read and written as 16-byte vectors where Dv and the pointers allow
// (all four loads in flight before any use); the halving sum takes levels
// 32 and 16 in registers and 8, 4, 2, 1 by shuffles among the sixteen
// lanes that share q.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_tiles.cuh"

namespace {

constexpr int MAXD = 64;            // largest D and Dv
constexpr int RES = 16;             // prefill threads per column of S
constexpr int PER = MAXD / RES;     // channels a prefill thread owns
constexpr int CPT = 2;              // columns of S a prefill thread owns
constexpr int THREADS = 128;        // a prefill block
constexpr int COLS = THREADS / RES * CPT;   // columns of S a prefill block
constexpr int CH = 16;              // steps staged in shared memory at once
constexpr int GAP = 4;              // floats between residues in a row
constexpr int ROW = RES * GAP + 4;  // floats a staged step of r, k or w (4
                                    // more: rows start 4 banks apart)
constexpr int LOADS = CH * MAXD / THREADS;  // r, k, w elements a thread
constexpr int VLOADS = CH * COLS / THREADS; // stages a chunk, and of v
constexpr unsigned FULL = 0xffffffffu;
static_assert(PER == GAP && CH == RES && VLOADS >= 1, "tiling");

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

// where channel i of a staged step lives: residue i % RES at GAP (i % RES),
// its PER channels adjacent (one 16-byte read; eight lanes' reads fall in
// distinct banks)
__device__ __forceinline__ int slot(int i) {
  return (i % RES) * GAP + i / RES;
}

// one step of one column for a thread's channels: the terms (S + u kv) r
// and the update S <- w S + kv, each op rounded on its own
__device__ __forceinline__ void step(const float* rr, const float* kk,
                                     const float* ww, const float* uu,
                                     float vj, float* S, float* term,
                                     int n) {
#pragma unroll
  for (int m = 0; m < n; ++m) {
    const float kv = __fmul_rn(kk[m], vj);
    term[m] = __fmul_rn(__fadd_rn(S[m], __fmul_rn(uu[m], kv)), rr[m]);
    S[m] = __fadd_rn(__fmul_rn(ww[m], S[m]), kv);
  }
}

// the levels h of the halving sum that pair a thread's own channels (c + RES
// m with c + RES (m + h / RES)): term[0] ends with their sum
template <int N>
__device__ __forceinline__ float own_levels(float* term) {
#pragma unroll
  for (int m = 0; m < N / 2; ++m) term[m] = __fadd_rn(term[m], term[m + N / 2]);
  if constexpr (N > 2) return own_levels<N / 2>(term);
  return term[0];
}

// the levels h < RES, across the lanes of a column, for N steps at once:
// lane c keeps half of them (the upper half if its bit h is set), adds lane
// c ^ h's share of those and hands over its share of the others (x_c +
// x_{c^h} is x_{c^h} + x_{c}, bit for bit); then the next level.  From N =
// RES steps lane c ends with step c in x[0].
template <int HM, int N>
__device__ __forceinline__ void trade(float* x, int c) {
  const bool hi = c & HM;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float lo = x[i], up = x[i + N / 2];
    x[i] = __fadd_rn(hi ? up : lo, __shfl_xor_sync(FULL, hi ? lo : up, HM));
  }
  if constexpr (HM > 1) trade<HM / 2, N / 2>(x, c);
}

// x in T, repeated to fill 32 bits
template <typename T> __device__ __forceinline__ uint32_t word(float x);
template <> __device__ __forceinline__ uint32_t word<float>(float x) {
  return __float_as_uint(x);
}
template <> __device__ __forceinline__ uint32_t word<__nv_bfloat16>(float x) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(x));
  return b << 16 | b;
}

// One chunk's inputs in flight, raw, converted to float32 only when they
// are staged (a conversion at the load would wait for it).  VEC: 16-byte
// loads (D and Dv multiples of 16 / sizeof(T), 16-byte aligned rows);
// else one element a load.  Element e = tid + THREADS n of r, k, w is
// channel e % 64 of step e / 64 (coalesced rows); of v, column e % COLS of
// step e / COLS.  Past T or D: r = k = v = 0, w = 1.
template <typename T, bool VEC>
struct Chunk {
  T r[LOADS], k[LOADS], w[LOADS], v[VLOADS];

  __device__ __forceinline__ void fetch(const T* rb, const T* kb,
                                        const T* wb, const T* vb, int t0,
                                        int Tn, int D, int Dv, int j0,
                                        size_t row_k, size_t row_v) {
#pragma unroll
    for (int n = 0; n < LOADS; ++n) {
      const int e = threadIdx.x + THREADS * n, t = t0 + e / MAXD,
                i = e % MAXD;
      const bool live = t < Tn && i < D;
      const size_t o = (size_t)t * row_k + i;
      r[n] = live ? rb[o] : from_f<T>(0.f);
      k[n] = live ? kb[o] : from_f<T>(0.f);
      w[n] = live ? wb[o] : from_f<T>(1.f);
    }
#pragma unroll
    for (int n = 0; n < VLOADS; ++n) {
      const int e = threadIdx.x + THREADS * n, t = t0 + e / COLS,
                j = j0 + e % COLS;
      v[n] = t < Tn && j < Dv ? vb[(size_t)t * row_v + j] : from_f<T>(0.f);
    }
  }

  __device__ __forceinline__ void stage(float (*rs)[ROW], float (*ks)[ROW],
                                        float (*ws)[ROW],
                                        float (*vs)[COLS]) const {
#pragma unroll
    for (int n = 0; n < LOADS; ++n) {
      const int e = threadIdx.x + THREADS * n, s = e / MAXD,
                p = slot(e % MAXD);
      rs[s][p] = to_f(r[n]);
      ks[s][p] = to_f(k[n]);
      ws[s][p] = to_f(w[n]);
    }
#pragma unroll
    for (int n = 0; n < VLOADS; ++n) {
      const int e = threadIdx.x + THREADS * n;
      vs[e / COLS][e % COLS] = to_f(v[n]);
    }
  }
};

template <typename T>
struct Chunk<T, true> {
  static constexpr int VW = 16 / sizeof(T);           // elements a load
  static constexpr int NV = CH * MAXD / VW / THREADS; // of r, k, w a thread
  static constexpr int VV = CH * COLS / VW;           // of v a block
  static_assert(NV >= 1 && VV <= THREADS && COLS % VW == 0,
                "vector tiling");
  uint4 r[NV], k[NV], w[NV], v;

  static __device__ __forceinline__ uint4 fill(float x) {
    const uint32_t b = word<T>(x);
    return make_uint4(b, b, b, b);
  }

  __device__ __forceinline__ void fetch(const T* rb, const T* kb,
                                        const T* wb, const T* vb, int t0,
                                        int Tn, int D, int Dv, int j0,
                                        size_t row_k, size_t row_v) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = threadIdx.x + THREADS * n, t = t0 + e / (MAXD / VW),
                i = e % (MAXD / VW) * VW;
      const bool live = t < Tn && i < D;
      const size_t o = (size_t)t * row_k + i;
      r[n] = live ? *reinterpret_cast<const uint4*>(rb + o) : fill(0.f);
      k[n] = live ? *reinterpret_cast<const uint4*>(kb + o) : fill(0.f);
      w[n] = live ? *reinterpret_cast<const uint4*>(wb + o) : fill(1.f);
    }
    const int e = threadIdx.x, t = t0 + e / (COLS / VW),
              j = j0 + e % (COLS / VW) * VW;
    v = e < VV && t < Tn && j < Dv
            ? *reinterpret_cast<const uint4*>(vb + (size_t)t * row_v + j)
            : fill(0.f);
  }

  __device__ __forceinline__ void stage(float (*rs)[ROW], float (*ks)[ROW],
                                        float (*ws)[ROW],
                                        float (*vs)[COLS]) const {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = threadIdx.x + THREADS * n, s = e / (MAXD / VW),
                i = e % (MAXD / VW) * VW;
      const T *a = reinterpret_cast<const T*>(&r[n]),
              *bb = reinterpret_cast<const T*>(&k[n]),
              *d = reinterpret_cast<const T*>(&w[n]);
#pragma unroll
      for (int q = 0; q < VW; ++q) {
        const int p = slot(i + q);
        rs[s][p] = to_f(a[q]);
        ks[s][p] = to_f(bb[q]);
        ws[s][p] = to_f(d[q]);
      }
    }
    const int e = threadIdx.x;
    if (e < VV) {
      const T* a = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int q = 0; q < VW; ++q)
        vs[e / (COLS / VW)][e % (COLS / VW) * VW + q] = to_f(a[q]);
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rwkv6_prefill(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ w,
              const T* __restrict__ u, const float* __restrict__ s0,
              T* __restrict__ y, float* __restrict__ sT, int Tn, int H,
              int D, int Dv) {
  __shared__ __align__(16) float rs[2][CH][ROW];
  __shared__ __align__(16) float ks[2][CH][ROW];
  __shared__ __align__(16) float ws[2][CH][ROW];
  __shared__ __align__(16) float vs[2][CH][COLS];
  __shared__ float ys[2][CH][COLS + 1];

  const int h = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * COLS;
  const int c = threadIdx.x % RES, jl = threadIdx.x / RES * CPT;
  const size_t bh = (size_t)b * H + h;
  const size_t row_k = (size_t)H * D, row_v = (size_t)H * Dv;
  const T* rb = r + (size_t)b * Tn * row_k + (size_t)h * D;
  const T* kb = k + (size_t)b * Tn * row_k + (size_t)h * D;
  const T* wb = w + (size_t)b * Tn * row_k + (size_t)h * D;
  const T* vb = v + (size_t)b * Tn * row_v + (size_t)h * Dv;
  T* yb = y + (size_t)b * Tn * row_v + (size_t)h * Dv;

  // channels c + RES m of columns j0 + jl + e; rows past D stay 0 (r = k =
  // u = 0 there)
  float uu[PER], S[CPT][PER];
  const float* s0b = s0 != nullptr ? s0 + bh * D * Dv : nullptr;
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = c + RES * m;
    uu[m] = i < D ? to_f(u[(size_t)h * D + i]) : 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int j = j0 + jl + e;
      S[e][m] = s0b != nullptr && i < D && j < Dv ? s0b[(size_t)i * Dv + j]
                                                  : 0.f;
    }
  }

  // chunk n in buffer n % 2: it runs while chunk n + 1 waits in the other
  // buffer and chunk n + 2 is in flight to registers
  auto run = [&](int buf) {
    float xs[CPT][CH];              // this thread's share of each step's y
#pragma unroll
    for (int s = 0; s < CH; ++s) {
      float rr[PER], kk[PER], ww[PER], vj[CPT];
#pragma unroll
      for (int q = 0; q < PER; q += 4) {
        const float4 a = *reinterpret_cast<const float4*>(
                         &rs[buf][s][c * GAP + q]),
                     bb = *reinterpret_cast<const float4*>(
                         &ks[buf][s][c * GAP + q]),
                     d = *reinterpret_cast<const float4*>(
                         &ws[buf][s][c * GAP + q]);
        rr[q] = a.x; rr[q + 1] = a.y; rr[q + 2] = a.z; rr[q + 3] = a.w;
        kk[q] = bb.x; kk[q + 1] = bb.y; kk[q + 2] = bb.z; kk[q + 3] = bb.w;
        ww[q] = d.x; ww[q + 1] = d.y; ww[q + 2] = d.z; ww[q + 3] = d.w;
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) vj[e] = vs[buf][s][jl + e];
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        float term[PER];
        step(rr, kk, ww, uu, vj[e], S[e], term, PER);
        xs[e][s] = own_levels<PER>(term);
      }
    }
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      trade<RES / 2, CH>(xs[e], c);
      ys[buf][c][jl + e] = xs[e][0];
    }
  };
  auto out = [&](int buf, int t0) {
#pragma unroll
    for (int n = 0; n < VLOADS; ++n) {
      const int e = threadIdx.x + THREADS * n, t = t0 + e / COLS,
                jj = j0 + e % COLS;
      if (t < Tn && jj < Dv)
        yb[(size_t)t * row_v + jj] = from_f<T>(ys[buf][e / COLS][e % COLS]);
    }
  };
  auto fetch = [&](Chunk<T, VEC>& in, int t0) {
    if (t0 < Tn) in.fetch(rb, kb, wb, vb, t0, Tn, D, Dv, j0, row_k, row_v);
  };

  Chunk<T, VEC> even, odd;          // chunks 2n and 2n + 1
  fetch(even, 0);
  even.stage(rs[0], ks[0], ws[0], vs[0]);
  fetch(odd, CH);
  __syncthreads();
  // a buffer's last readers finished before the barrier ahead of its stage
  for (int t0 = 0; t0 < Tn; t0 += 2 * CH) {
    fetch(even, t0 + 2 * CH);
    run(0);
    if (t0 + CH < Tn) odd.stage(rs[1], ks[1], ws[1], vs[1]);
    __syncthreads();
    out(0, t0);
    if (t0 + CH >= Tn) break;
    fetch(odd, t0 + 3 * CH);
    run(1);
    if (t0 + 2 * CH < Tn) even.stage(rs[0], ks[0], ws[0], vs[0]);
    __syncthreads();
    out(1, t0 + CH);
  }

  float* sb = sT + bh * D * Dv;
#pragma unroll
  for (int e = 0; e < CPT; ++e) {
    const int j = j0 + jl + e;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int i = c + RES * m;
      if (i < D && j < Dv) sb[(size_t)i * Dv + j] = S[e][m];
    }
  }
}

// ---------------------------------------------------------------------------
// the chunked prefill (the note at the top says what and why)
// ---------------------------------------------------------------------------
constexpr int C = 16;               // steps a chunk
constexpr int TT = 256;             // a team: 8 warps
constexpr int CT = 2 * TT;          // a chunked block: the products team
                                    // (threads 0-255), the prep team
constexpr int NW = TT / 32;         // warps a team
constexpr int SLICE = 16;           // channels of a slice
constexpr int NSL = MAXD / SLICE;   // slices: warps w and w + NSL share one
constexpr int JW = 16;              // columns of S and y a warp owns
constexpr int NJ = JW * NW / NSL;   // columns a block owns
constexpr int LD = 24;              // bf16 row of a slice tile (48 bytes:
                                    // ldmatrix's 8 rows in distinct banks)
constexpr int FLD = SLICE + 4;      // float row of a slice tile
constexpr float FACTOR_MIN = 5.421010862427522e-20f;   // 2^-64
static_assert(NSL * 2 == NW && NJ == 32 && C == 16 && JW == 16
              && C * NJ / 2 == TT, "tiling");

// A chunk of inputs in their own type: r, k, w of all MAXD channels (rows
// past D or T are zero; the prep reads w = 1 there), v of the block's NJ
// columns.  Rows are padded by 16 bytes (r, k, w: the prep's eight rows
// 2sg + m fall in four bank groups, not one; v: 80 bytes in bf16,
// ldmatrix's 8 rows in distinct banks).
template <typename T>
struct Stage {
  static constexpr int KROW = MAXD + 16 / sizeof(T);
  static constexpr int VROW = NJ + 8;
  static constexpr int ARR = C * KROW * sizeof(T);  // bytes of r (k, w)
  T r[C][KROW], k[C][KROW], w[C][KROW], v[C][VROW];
};
static_assert(sizeof(Stage<float>) == 3 * Stage<float>::ARR
              + C * Stage<float>::VROW * 4, "r, k, w, v packed in order");

// The prep team's loads of a chunk into a stage.  VEC (D and Dv multiples
// of 16 / sizeof(T), 16-byte aligned pointers): each thread owns at most
// one 16-byte cp.async piece of r, k and w and one of v, whose addresses
// it works out once; a piece past D, Dv or T is zero-filled.  Else element
// by element, complete on return.  Every thread commits one group either
// way.
template <typename T, bool VEC>
struct Loader {
  static constexpr int VW = 16 / sizeof(T);
  static constexpr int PR = MAXD / VW;          // pieces a row of r, k, w
  static constexpr int PV = NJ / VW;            // pieces a row of v
  static_assert(C * PR <= TT && C * PV <= TT, "one piece a thread");
  const T *rb, *kb, *wb, *vb;
  int Tn, D, Dv, j0;
  size_t row_k, row_v;
  int t_k = -1, t_v = -1;           // the pieces' steps in a chunk (-1: none)
  bool live_k = false, live_v = false;
  size_t src_k = 0, src_v = 0;      // element offsets at step 0
  int dst_k = 0, dst_v = 0;         // byte offsets in a stage

  __device__ __forceinline__ Loader(const T* r, const T* k, const T* w,
                                    const T* v, int Tn_, int D_, int Dv_,
                                    int j0_, size_t row_k_, size_t row_v_)
      : rb(r), kb(k), wb(w), vb(v), Tn(Tn_), D(D_), Dv(Dv_), j0(j0_),
        row_k(row_k_), row_v(row_v_) {
    const int e = threadIdx.x % TT;
    if (VEC && e < C * PR) {
      t_k = e / PR;
      const int i = e % PR * VW;
      live_k = i < D;
      src_k = (size_t)t_k * row_k + i;
      dst_k = (t_k * Stage<T>::KROW + i) * (int)sizeof(T);
    }
    if (VEC && e < C * PV) {
      t_v = e / PV;
      const int j = e % PV * VW;
      live_v = j0 + j < Dv;
      src_v = (size_t)t_v * row_v + j0 + j;
      dst_v = 3 * Stage<T>::ARR
              + (t_v * Stage<T>::VROW + j) * (int)sizeof(T);
    }
  }

  // chunk at t0 into st
  __device__ __forceinline__ void request(Stage<T>& st, int t0) const {
    if (!VEC) {
      for (int e = threadIdx.x % TT; e < C * MAXD; e += TT) {
        const int t = e / MAXD, i = e % MAXD;
        const bool live = t0 + t < Tn && i < D;
        const size_t o = (size_t)(t0 + t) * row_k + i;
        st.r[t][i] = live ? rb[o] : from_f<T>(0.f);
        st.k[t][i] = live ? kb[o] : from_f<T>(0.f);
        st.w[t][i] = live ? wb[o] : from_f<T>(1.f);
      }
      for (int e = threadIdx.x % TT; e < C * NJ; e += TT) {
        const int t = e / NJ, j = e % NJ;
        const bool live = t0 + t < Tn && j0 + j < Dv;
        st.v[t][j] = live ? vb[(size_t)(t0 + t) * row_v + j0 + j]
                          : from_f<T>(0.f);
      }
    } else {
      char* base = reinterpret_cast<char*>(&st);
      constexpr int ARR = Stage<T>::ARR;
      if (t_k >= 0) {
        const bool live = live_k && t0 + t_k < Tn;
        const size_t o = live ? (size_t)t0 * row_k + src_k : 0;
        sm90::cp_async16(base + dst_k, rb + o, live);
        sm90::cp_async16(base + dst_k + ARR, kb + o, live);
        sm90::cp_async16(base + dst_k + 2 * ARR, wb + o, live);
      }
      if (t_v >= 0) {
        const bool live = live_v && t0 + t_v < Tn;
        sm90::cp_async16(base + dst_v,
                         vb + (live ? (size_t)t0 * row_v + src_v : 0), live);
      }
    }
    sm90::cp_async_commit();
  }
};

// channels i and i + 1 (i even) of a staged row, as float32
__device__ __forceinline__ float2 pair(const float* row, int i) {
  return *reinterpret_cast<const float2*>(row + i);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + i));
}

// w_t of channel i; steps past T (live false) and channels past D decay by
// exactly 1
template <typename T>
__device__ __forceinline__ float decay(const Stage<T>& st, int t, int i,
                                       bool live) {
  return live ? to_f(st.w[t][i]) : 1.f;
}

// A_ts over the channels [i0, i0 + SLICE) of a chunk, s < t, from running
// products (the pairwise form: any decay, w = 0 and underflow included):
// Σ_i (r_ti (w_{s+1} ... w_{t-1})_i) k_si, each product built from w_{s+1}
// up as rwkv6_chunked_torch builds it
template <typename T>
__device__ __forceinline__ float pairwise(const Stage<T>& st, int t, int s,
                                          int i0, int live_t, int D) {
  float acc = 0.f;
  for (int i = i0; i < i0 + SLICE && i < D; ++i) {
    float dec = 1.f;
    for (int m = s + 1; m < t; ++m) dec *= decay(st, m, i, m < live_t);
    acc += to_f(st.r[t][i]) * dec * to_f(st.k[s][i]);
  }
  return acc;
}

// What the prep leaves for a slice of a chunk: q = r ⊙ P, kk = k / P and
// ks = k ⊙ Σ ([step][channel]), P_C, its two prep warps' shares of diag(r u k)
// and, for a chunk the factorised form cannot take, its pairwise A.  bf16:
// q, kk and ks as their three bf16 pieces, the tensor cores' operands.
enum Tile { Q, KK, KS };
constexpr int NP = 3;               // bf16 pieces of a float32 operand

// x and y (x in the low half of each word) as NP bf16 pairs, each the
// nearest-even bf16 of what the pieces before it leave: their sum carries
// the 24 bits of a float32 significand (each remainder is exact)
__device__ __forceinline__ void split3(float x, float y, uint32_t (&p)[NP]) {
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    p[n] = *reinterpret_cast<const uint32_t*>(&h);
    x -= f.x;
    y -= f.y;
  }
}

struct SliceBf16 {
  __nv_bfloat16 part[NP][3][C][LD];
  float pc[SLICE], d[2][C], a[C][C + 1];
  // channels il, il + 1 (il even) of step t
  __device__ __forceinline__ void put(int tile, int t, int il, float x,
                                      float y) {
    uint32_t p[NP];
    split3(x, y, p);
#pragma unroll
    for (int n = 0; n < NP; ++n)
      *reinterpret_cast<uint32_t*>(&part[n][tile][t][il]) = p[n];
  }
  __device__ __forceinline__ void put1(int tile, int t, int il, float x) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const __nv_bfloat16 h = __float2bfloat16(x);
      part[n][tile][t][il] = h;
      x -= __bfloat162float(h);
    }
  }
};

struct SliceF32 {
  float f[3][C][FLD];
  float pc[SLICE], d[2][C], a[C][C + 1];
  __device__ __forceinline__ void put(int tile, int t, int il, float x,
                                      float y) {
    *reinterpret_cast<float2*>(&f[tile][t][il]) = make_float2(x, y);
  }
  __device__ __forceinline__ void put1(int tile, int t, int il, float x) {
    f[tile][t][il] = x;
  }
};

// One chunk's decay products into its tiles, the prep team: its warp w
// takes channels 8w .. 8w + 7 (half of slice w / 2), lane (sg, cp)
// the channel pair 8w + 2cp, + 1 at steps 2sg, 2sg + 1.  P_t = w_0 ...
// w_{t-1}: each lane's two-step products, then a scan over the eight lanes
// sg (shuffles); ks = kk P_C (= k ⊙ Σ while the chunk is factorised; the
// pairwise path forms it from running products).  Returns whether every
// P_{t+1} of the lane's steps is >= FACTOR_MIN (the factorised form).
template <typename T, typename Slice>
__device__ __forceinline__ bool prep(const Stage<T>& in, Slice* tiles,
                                     float2 uu, int live_t, int D) {
  const int lane = threadIdx.x % 32, wi = threadIdx.x % TT / 32;
  const int cp = lane % 4, sg = lane / 4;
  const int il = wi % 2 * 8 + 2 * cp, i = wi * 8 + 2 * cp;
  Slice& tl = tiles[wi / 2];
  const bool l0 = i < D, l1 = i + 1 < D;
  const int ta = 2 * sg, tb = ta + 1;
  const float2 wa = pair(in.w[ta], i), wb = pair(in.w[tb], i);
  const float2 a = make_float2(l0 && ta < live_t ? wa.x : 1.f,
                               l1 && ta < live_t ? wa.y : 1.f);
  const float2 b = make_float2(l0 && tb < live_t ? wb.x : 1.f,
                               l1 && tb < live_t ? wb.y : 1.f);
  float2 inc = make_float2(a.x * b.x, a.y * b.y);
#pragma unroll
  for (int d = 1; d < 8; d *= 2) {  // inclusive scan over sg
    const float x = __shfl_up_sync(FULL, inc.x, 4 * d),
                y = __shfl_up_sync(FULL, inc.y, 4 * d);
    if (sg >= d) inc = make_float2(x * inc.x, y * inc.y);
  }
  float2 e = make_float2(__shfl_up_sync(FULL, inc.x, 4),
                         __shfl_up_sync(FULL, inc.y, 4));
  if (sg == 0) e = make_float2(1.f, 1.f);
  const float2 pc = make_float2(__shfl_sync(FULL, inc.x, 28 + cp),
                                __shfl_sync(FULL, inc.y, 28 + cp));
  if (sg == 0) {
    tl.pc[il] = pc.x;
    tl.pc[il + 1] = pc.y;
  }
  const float2 p[3] = {e, make_float2(e.x * a.x, e.y * a.y),
                       make_float2(e.x * a.x * b.x, e.y * a.y * b.y)};
  bool fast = true;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int t = ta + m;
    const float2 r = pair(in.r[t], i), k = pair(in.k[t], i);
    const float2 p0 = p[m], p1 = p[m + 1];
    fast = fast && p1.x >= FACTOR_MIN && p1.y >= FACTOR_MIN;
    const float kx = __fdividef(k.x, p1.x), ky = __fdividef(k.y, p1.y);
    tl.put(Q, t, il, r.x * p0.x, r.y * p0.y);
    tl.put(KK, t, il, kx, ky);
    tl.put(KS, t, il, kx * pc.x, ky * pc.y);
    // the 8 channels' share of Σ_i r u k (pairs, then lanes cp)
    float x = r.x * uu.x * k.x + r.y * uu.y * k.y;
    x += __shfl_xor_sync(FULL, x, 1);
    x += __shfl_xor_sync(FULL, x, 2);
    if (cp == 0) tl.d[wi % 2][t] = x;
  }
  return fast;
}

// A chunk the factorised form cannot take: ks = k ⊙ Σ from running
// products from the top (no division), and each slice's A from pairwise
// products; every thread of both teams, then a barrier
template <typename T, typename Slice>
__device__ __forceinline__ void unfactorised(const Stage<T>& in,
                                             Slice* tiles, int live_t,
                                             int D) {
  const int tid = threadIdx.x;
  if (tid < MAXD) {
    const int i = tid;
    const bool live_i = i < D;
    float sig = 1.f;                // Σ_s = w_{s+1} ... w_{C-1}
    for (int s = C - 1; s >= 0; --s) {
      tiles[i / SLICE].put1(KS, s, i % SLICE, to_f(in.k[s][i]) * sig);
      sig *= decay(in, s, i, live_i && s < live_t);
    }
  }
  constexpr int PAIRS = C * (C - 1) / 2;
  for (int p = tid; p < NSL * PAIRS; p += CT) {
    const int sl = p / PAIRS;
    int t = 1, s = p % PAIRS;       // pair p, row by row: s < t
    while (s >= t) { s -= t; ++t; }
    tiles[sl].a[t][s] = pairwise(in, t, s, sl * SLICE, live_t, D);
  }
  __syncthreads();
}

// d += a b for a and b in NP pieces each: the piece products down to 2^-16
// of the leading one, largest first (a0 b0, a0 b1, a1 b0, a0 b2, a1 b1, a2
// b0); a's pieces A fragments, b's B fragments f and f + 1 of each piece
__device__ __forceinline__ void mma6(float (&d)[4], const uint32_t (&a)[NP][4],
                                     const uint32_t (&b)[NP][4], int f) {
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int m = 0; m <= n; ++m)
      sm90::mma_bf16(d, a[m], b[n - m][f], b[n - m][f + 1]);
}

// the block's y tile of a chunk, by the prep team: the NSL warps' shares
// of each column summed (slices in order), rounded to T, two columns a
// thread (the thread's step and columns worked out once)
template <typename T>
struct YOut {
  static_assert(C * NJ / 2 == TT, "two columns a thread");
  T* dst;                           // at step 0
  int t, jl, jg;
  bool live0, live1;

  __device__ __forceinline__ YOut(T* yb, int j0, int Dv, size_t row_v) {
    const int e = threadIdx.x % TT, j = e % (NJ / 2) * 2;
    t = e / (NJ / 2);
    jg = j / JW;
    jl = j % JW;
    live0 = j0 + j < Dv;
    live1 = j0 + j + 1 < Dv;
    dst = yb + (size_t)t * row_v + j0 + j;
  }

  __device__ __forceinline__ void store(const float (*yp)[C][JW + 1],
                                        int t0, int live_t,
                                        size_t row_v) const {
    if (t >= live_t || !live0) return;
    float out[2] = {};
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl) {
      out[0] += yp[jg * NSL + sl][t][jl];
      out[1] += yp[jg * NSL + sl][t][jl + 1];
    }
    T* d = dst + (size_t)t0 * row_v;
    d[0] = from_f<T>(out[0]);
    if (live1) d[1] = from_f<T>(out[1]);
  }
};

template <typename T, typename Slice, int STAGES, int EXTRA>
struct ChunkSmem {
  static constexpr int NS = STAGES;
  Stage<T> ring[NS];                // chunk c in ring[c % NS]
  Slice tiles[2][NSL];              // chunk c's in tiles[c % 2]
  float y[2][NW][C][JW + 1];        // each warp's share of its y tile
  float s[EXTRA][SLICE][JW + 4];    // float32: each warp's block of S
};
// stages: a power of two, six chunks in flight beyond the two the teams
// work on (a deeper ring, to 16 stages, moved nothing on the card)
using SmemBf16 = ChunkSmem<__nv_bfloat16, SliceBf16, 8, 1>;
using SmemF32 = ChunkSmem<float, SliceF32, 8, NW>;

// The chunk loop both types share.  Two teams: in the pass of chunk c the
// prep team writes chunk c - 1's y, forms chunk c + 1's tiles (CUDA
// cores), asks for chunk c + NS - 1 and waits for chunk c + 2, while the
// products team runs chunk c's products (``products``); then one barrier
// publishes both and carries chunk c + 1's vote.
template <typename T, bool VEC, typename Smem, typename Products>
__device__ __forceinline__ void chunk_loop(Smem& sm, const T* rb,
                                           const T* kb, const T* wb,
                                           const T* vb, const T* u, T* yb,
                                           int Tn, int h, int D, int Dv,
                                           int j0, size_t row_k,
                                           size_t row_v, Products products) {
  constexpr int NS = Smem::NS;
  static_assert(NS >= 3 && (NS & (NS - 1)) == 0, "stages");
  const bool prepper = threadIdx.x >= TT;
  const int nc = (Tn + C - 1) / C;
  const int iu = threadIdx.x % TT / 32 * 8 + threadIdx.x % 4 * 2;
  const float2 uu = make_float2(iu < D ? to_f(u[(size_t)h * D + iu]) : 0.f,
                                iu + 1 < D ? to_f(u[(size_t)h * D + iu + 1])
                                           : 0.f);
  const Loader<T, VEC> loader(rb, kb, wb, vb, Tn, D, Dv, j0, row_k, row_v);
  auto load = [&](int c) {          // chunk c into ring[c % NS], if any
    if (c < nc)
      loader.request(sm.ring[c % NS], c * C);
    else
      sm90::cp_async_commit();
  };
  const YOut<T> out(yb, j0, Dv, row_v);
  if (prepper) {
    for (int c = 0; c < NS - 1; ++c) load(c);
    sm90::cp_async_wait<NS - 3>();  // chunks 0 and 1
  }
  __syncthreads();
  bool fast = __syncthreads_and(
      !prepper || prep(sm.ring[0], sm.tiles[0], uu, Tn, D));
  for (int c = 0; c < nc; ++c) {
    const Stage<T>& in = sm.ring[c % NS];
    const int t0 = c * C, live_t = Tn - t0;     // steps < live_t are real
    if (!fast) unfactorised(in, sm.tiles[c % 2], live_t, D);
    bool next = true;
    if (prepper) {
      if (c > 0) out.store(sm.y[(c - 1) % 2], t0 - C, live_t + C, row_v);
      if (c + 1 < nc)
        next = prep(sm.ring[(c + 1) % NS], sm.tiles[(c + 1) % 2], uu,
                    live_t - C, D);
      load(c + NS - 1);             // into chunk c - 1's stage
      sm90::cp_async_wait<NS - 3>();              // chunk c + 2
    } else {
      products(in, sm.tiles[c % 2], fast, sm.y[c % 2]);
    }
    fast = __syncthreads_and(next);
  }
  if (prepper && nc > 0)
    out.store(sm.y[(nc - 1) % 2], (nc - 1) * C, Tn - (nc - 1) * C, row_v);
}

// bf16: block (z, h, b) owns columns NJ z .. NJ z + NJ - 1 of S and y; warp
// w slice sl = w % NSL and columns jg = w / NSL of those.  Per chunk on the
// tensor cores (mma.sync m16n8k16, float32 accumulators), each warp for
// its slice's channels: A_w = q kkᵀ (six mma a tile, mma6), masked to
// s < t, its share of diag(r u k) on the diagonal; Y_w = A_w V + q S (S's
// pieces from the warp's float32 Sᵀ accumulators);
// then Sᵀ_w = P_C Sᵀ_w + Vᵀ (k ⊙ Σ).  The NSL shares of each y column meet
// in shared memory.
template <bool VEC>
__global__ void __launch_bounds__(CT)
rwkv6_chunked_bf16(const __nv_bfloat16* __restrict__ r,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ u,
                   const float* __restrict__ s0, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ sT, int Tn, int H, int D, int Dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_raw);
  const int j0 = blockIdx.x * NJ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32;
  const int sl = wi % NSL, jg = wi / NSL, g = lane / 4, tq = lane % 4;
  const size_t bh = (size_t)b * H + h;
  const size_t row_k = (size_t)H * D, row_v = (size_t)H * Dv;
  const size_t ok = (size_t)b * Tn * row_k + (size_t)h * D;
  const size_t ov = (size_t)b * Tn * row_v + (size_t)h * Dv;

  // Sᵀ of a products warp: tile nt holds (j = j0 + JW jg + g, + 8; i =
  // SLICE sl + 8 nt + 2 tq, + 1) in the accumulator layout
  const bool products_team = threadIdx.x < TT;
  float st[2][4] = {};
  const float* s0b = s0 != nullptr ? s0 + bh * D * Dv : nullptr;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = sl * SLICE + nt * 8 + 2 * tq + (e & 1);
      const int jj = j0 + jg * JW + g + (e >> 1) * 8;
      if (products_team && s0b != nullptr && ii < D && jj < Dv)
        st[nt][e] = s0b[(size_t)ii * Dv + jj];
    }

  auto products = [&](const Stage<__nv_bfloat16>& in, SliceBf16* tiles,
                      bool fast, float (*yp)[C][JW + 1]) {
    const SliceBf16& tl = tiles[sl];
    // fragments: q (t x i) as A; kk (s x i) as B, (s 0-7, i 0-7) (s 0-7,
    // i 8-15) (s 8-15, i 0-7) (s 8-15, i 8-15); V (s x j) as B, (s 0-7,
    // j 0-7) (s 8-15, j 0-7) (s 0-7, j 8-15) (s 8-15, j 8-15), and the same
    // as Vᵀ (j x s) A fragments; ks (s x i) as B of Vᵀ ks, transposed:
    // (s 0-7, i 0-7) (s 8-15, i 0-7) (s 0-7, i 8-15) (s 8-15, i 8-15)
    uint32_t qf[NP][4], kf[NP][4], vm[4], xf[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      sm90::ldmatrix_x4(qf[n], &tl.part[n][Q][lane % 16][lane / 16 * 8]);
      const int sr = lane / 16 * 8 + lane % 8, ic = lane / 8 % 2 * 8;
      sm90::ldmatrix_x4(kf[n], &tl.part[n][KK][sr][ic]);
      const int xr = lane / 8 % 2 * 8 + lane % 8, xc = lane / 16 * 8;
      sm90::ldmatrix_x4_trans(xf[n], &tl.part[n][KS][xr][xc]);
    }
    sm90::ldmatrix_x4_trans(
        vm, &in.v[lane / 8 % 2 * 8 + lane % 8][jg * JW + lane / 16 * 8]);
    uint32_t sf[NP][4];     // S (i x j) as B: [piece][2 j tile + i half]
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t p[NP];
        split3(st[kt][2 * jt], st[kt][2 * jt + 1], p);
#pragma unroll
        for (int n = 0; n < NP; ++n) sf[n][2 * jt + kt] = p[n];
      }

    // three independent chains: A_w = q kkᵀ (tile nt: t = g, + 8; s = 8 nt
    // + 2 tq, + 1; in a chunk the vote sends to the pairwise form, kk is
    // not used and the tile is replaced below), Y_w = q S, and Sᵀ_w = P_C
    // Sᵀ_w + Vᵀ (k ⊙ Σ)
    float a[2][4] = {}, yw[2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma6(a[nt], qf, kf, 2 * nt);
      mma6(yw[nt], qf, sf, 2 * nt);
    }
    const uint32_t vt[4] = {vm[0], vm[2], vm[1], vm[3]};     // Vᵀ (j x s)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float p0 = tl.pc[nt * 8 + 2 * tq],
                  p1 = tl.pc[nt * 8 + 2 * tq + 1];
      st[nt][0] *= p0; st[nt][1] *= p1; st[nt][2] *= p0; st[nt][3] *= p1;
#pragma unroll
      for (int n = 0; n < NP; ++n)
        sm90::mma_bf16(st[nt], vt, xf[n][2 * nt], xf[n][2 * nt + 1]);
    }

    // A_w masked to s < t, this slice's share of diag(r u k) on the
    // diagonal ((t, t) is element (g & 1) of tile 0, t = g, and 2 + (g & 1)
    // of tile 1, t = g + 8, held where 2 tq = g & ~1); then Y_w += A_w V
    const bool diag = g / 2 == tq;
    const float d0 = diag ? tl.d[0][g] + tl.d[1][g] : 0.f,
                d8 = diag ? tl.d[0][g + 8] + tl.d[1][g + 8] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + (e >> 1) * 8, s = nt * 8 + 2 * tq + (e & 1);
        a[nt][e] = s == t ? (nt == 0 ? d0 : d8)
                   : s > t ? 0.f : fast ? a[nt][e] : tl.a[t][s];
      }
    uint32_t af[NP][4];             // A_w (t x s) as A: its pieces
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      uint32_t p[NP];
      split3(a[f / 2][f % 2 * 2], a[f / 2][f % 2 * 2 + 1], p);
#pragma unroll
      for (int n = 0; n < NP; ++n) af[n][f] = p[n];
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int n = 0; n < NP; ++n)
        sm90::mma_bf16(yw[jt], af[n], vm[2 * jt], vm[2 * jt + 1]);
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yp[wi][g + (e >> 1) * 8][jt * 8 + 2 * tq + (e & 1)] = yw[jt][e];
  };
  chunk_loop<__nv_bfloat16, VEC>(sm, r + ok, k + ok, w + ok, v + ov, u,
                                 y + ov, Tn, h, D, Dv, j0, row_k, row_v,
                                 products);

  if (!products_team) return;
  float* sb = sT + bh * D * Dv;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = sl * SLICE + nt * 8 + 2 * tq + (e & 1);
      const int jj = j0 + jg * JW + g + (e >> 1) * 8;
      if (ii < D && jj < Dv) sb[(size_t)ii * Dv + jj] = st[nt][e];
    }
}

// float32: the same blocks, warps, chunks, prep and vote, and the same
// three products a warp, on the CUDA cores in float32 (fmaf): lane (hh,
// row) = (lane / 16, lane % 16) forms row t = row of A_w over s in [8 hh,
// 8 hh + 8) and takes the other half from lane ^ 16, then Y_w[t][j] and
// S_w[i = row][j] for its 8 columns j in [8 hh, 8 hh + 8) of the warp's
// 16; S_w lives in shared memory.
template <bool VEC>
__global__ void __launch_bounds__(CT)
rwkv6_chunked_f32(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ sT, int Tn,
                  int H, int D, int Dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemF32& sm = *reinterpret_cast<SmemF32*>(smem_raw);
  const int j0 = blockIdx.x * NJ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32;
  const int sl = wi % NSL, jg = wi / NSL;
  const int row = lane % 16, hh = lane / 16;    // t of Y, i of S
  const size_t bh = (size_t)b * H + h;
  const size_t row_k = (size_t)H * D, row_v = (size_t)H * Dv;
  const size_t ok = (size_t)b * Tn * row_k + (size_t)h * D;
  const size_t ov = (size_t)b * Tn * row_v + (size_t)h * Dv;
  const bool products_team = threadIdx.x < TT;
  float (*S)[JW + 4] = sm.s[wi % NW];
  const int jv = jg % 2 * JW + 8 * hh;          // the lane's 8 columns

  const float* s0b = s0 != nullptr ? s0 + bh * D * Dv : nullptr;
  const int ii = sl * SLICE + row;
  if (products_team)
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int jj = j0 + jv + m;
      S[row][8 * hh + m] = s0b != nullptr && ii < D && jj < Dv
                               ? s0b[(size_t)ii * Dv + jj] : 0.f;
    }

  auto products = [&](const Stage<float>& in, SliceF32* tiles, bool fast,
                      float (*yp)[C][JW + 1]) {
    const SliceF32& tl = tiles[sl];
    // ---- row t = row of A_w: s in [8 hh, 8 hh + 8) here, the rest from
    // lane ^ 16 ----
    float q[SLICE], mine[8], a[C];
#pragma unroll
    for (int i = 0; i < SLICE; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&tl.f[Q][row][i]);
      q[i] = x.x; q[i + 1] = x.y; q[i + 2] = x.z; q[i + 3] = x.w;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int s = 8 * hh + m;
      float acc = 0.f;
      if (fast) {
#pragma unroll
        for (int i = 0; i < SLICE; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(&tl.f[KK][s][i]);
          acc = fmaf(q[i], x.x, acc);
          acc = fmaf(q[i + 1], x.y, acc);
          acc = fmaf(q[i + 2], x.z, acc);
          acc = fmaf(q[i + 3], x.w, acc);
        }
      } else {
        acc = tl.a[row][s];
      }
      mine[m] = s == row ? tl.d[0][row] + tl.d[1][row]
                : s > row ? 0.f : acc;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float other = __shfl_xor_sync(FULL, mine[m], 16);
      a[m] = hh == 0 ? mine[m] : other;
      a[8 + m] = hh == 0 ? other : mine[m];
    }

    // ---- Y_w[row][j] = Σ_s A V + Σ_i q S ----
    float yw[8] = {};
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const float4 v0 = *reinterpret_cast<const float4*>(&in.v[s][jv]),
                   v1 = *reinterpret_cast<const float4*>(&in.v[s][jv + 4]);
      const float vs[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m) yw[m] = fmaf(a[s], vs[m], yw[m]);
    }
#pragma unroll
    for (int i = 0; i < SLICE; ++i) {
      const float4 s0v = *reinterpret_cast<const float4*>(&S[i][8 * hh]),
                   s1v = *reinterpret_cast<const float4*>(&S[i][8 * hh + 4]);
      const float ss[8] = {s0v.x, s0v.y, s0v.z, s0v.w,
                           s1v.x, s1v.y, s1v.z, s1v.w};
#pragma unroll
      for (int m = 0; m < 8; ++m) yw[m] = fmaf(q[i], ss[m], yw[m]);
    }
    __syncwarp();

    // ---- S_w[row][j] = P_C S + Σ_s ks[s][row] v[s][j] ----
    float sn[8];
    const float pc = tl.pc[row];
#pragma unroll
    for (int m = 0; m < 8; ++m) sn[m] = pc * S[row][8 * hh + m];
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const float ks = tl.f[KS][s][row];
      const float4 v0 = *reinterpret_cast<const float4*>(&in.v[s][jv]),
                   v1 = *reinterpret_cast<const float4*>(&in.v[s][jv + 4]);
      const float vs[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m) sn[m] = fmaf(ks, vs[m], sn[m]);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      S[row][8 * hh + m] = sn[m];
      yp[wi][row][8 * hh + m] = yw[m];
    }
  };
  chunk_loop<float, VEC>(sm, r + ok, k + ok, w + ok, v + ov, u, y + ov, Tn,
                         h, D, Dv, j0, row_k, row_v, products);

  if (!products_team) return;
  float* sb = sT + bh * D * Dv;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int jj = j0 + jv + m;
    if (ii < D && jj < Dv) sb[(size_t)ii * Dv + jj] = S[row][8 * hh + m];
  }
}

constexpr int DEC_THREADS = 256;    // a decode block: 16 quads x 16 rows

// T == 1: thread (q, c) = (tid / 16, tid % 16) owns S[c + 16 m][4 q + e]
template <typename T, bool VEC>
__global__ void __launch_bounds__(DEC_THREADS)
rwkv6_decode(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const T* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ y, float* __restrict__ sT, int H, int D,
             int Dv) {
  __shared__ float rs[MAXD], ks[MAXD], ws[MAXD], us[MAXD], vs[MAXD];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int c = tid % 16, q = tid / 16;
  const size_t bh = (size_t)b * H + h;

  float S[4][4];
  const float* s0b = s0 != nullptr ? s0 + bh * D * Dv : nullptr;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = c + 16 * m;
    if (VEC) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0b != nullptr && i < D && 4 * q < Dv)
        x = *reinterpret_cast<const float4*>(s0b + (size_t)i * Dv + 4 * q);
      S[m][0] = x.x; S[m][1] = x.y; S[m][2] = x.z; S[m][3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        S[m][e] = s0b != nullptr && i < D && j < Dv
                      ? s0b[(size_t)i * Dv + j] : 0.f;
      }
    }
  }
  if (tid < MAXD) {
    const size_t o = bh * D + tid;
    const bool live = tid < D;
    rs[tid] = live ? to_f(r[o]) : 0.f;
    ks[tid] = live ? to_f(k[o]) : 0.f;
    ws[tid] = live ? to_f(w[o]) : 0.f;
    us[tid] = live ? to_f(u[(size_t)h * D + tid]) : 0.f;
    vs[tid] = tid < Dv ? to_f(v[bh * Dv + tid]) : 0.f;
  }
  __syncthreads();

  float rr[4], kk[4], ww[4], uu[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    rr[m] = rs[c + 16 * m]; kk[m] = ks[c + 16 * m];
    ww[m] = ws[c + 16 * m]; uu[m] = us[c + 16 * m];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float col[4], term[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) col[m] = S[m][e];
    step(rr, kk, ww, uu, vs[4 * q + e], col, term, 4);
#pragma unroll
    for (int m = 0; m < 4; ++m) S[m][e] = col[m];
    // h = 32, 16 in registers; 8, 4, 2, 1 across the lanes sharing q
    float x = __fadd_rn(__fadd_rn(term[0], term[2]),
                        __fadd_rn(term[1], term[3]));
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, 8));
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, 4));
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, 2));
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, 1));
    const int j = 4 * q + e;
    if (c == 0 && j < Dv) y[bh * Dv + j] = from_f<T>(x);
  }

  float* sb = sT + bh * D * Dv;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = c + 16 * m;
    if (i >= D) continue;
    if (VEC) {
      if (4 * q < Dv)
        *reinterpret_cast<float4*>(sb + (size_t)i * Dv + 4 * q) =
            make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < Dv) sb[(size_t)i * Dv + 4 * q + e] = S[m][e];
    }
  }
}

// the chunked prefill of (B, H) heads over Tn steps
template <typename T, bool VEC>
int launch_chunked(const T* r, const T* k, const T* v, const T* w,
                   const T* u, const float* s0, T* y, float* sT, int B,
                   int Tn, int H, int D, int Dv, cudaStream_t stream) {
  static unsigned smem_set = 0;     // this instantiation's devices
  const dim3 grid((Dv + NJ - 1) / NJ, H, B);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    constexpr int bytes = sizeof(SmemF32);
    err = sm90::set_smem_once(rwkv6_chunked_f32<VEC>, bytes, smem_set);
    if (err == cudaSuccess)
      rwkv6_chunked_f32<VEC><<<grid, CT, bytes, stream>>>(
          r, k, v, w, u, s0, y, sT, Tn, H, D, Dv);
  } else {
    constexpr int bytes = sizeof(SmemBf16);
    err = sm90::set_smem_once(rwkv6_chunked_bf16<VEC>, bytes, smem_set);
    if (err == cudaSuccess)
      rwkv6_chunked_bf16<VEC><<<grid, CT, bytes, stream>>>(
          r, k, v, w, u, s0, y, sT, Tn, H, D, Dv);
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int form, int B,
           int Tn, int H, int D, int Dv, cudaStream_t stream) {
  const T *rp = static_cast<const T*>(r), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *wp = static_cast<const T*>(w),
          *up = static_cast<const T*>(u);
  const float* s0p = static_cast<const float*>(s0);
  T* yp = static_cast<T*>(y);
  float* sp = static_cast<float*>(sT);
  constexpr int vw = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)r | (uintptr_t)k | (uintptr_t)w
                        | (uintptr_t)v) % 16 == 0;
  if (Tn == 1) {
    const bool vec = Dv % 4 == 0 && (uintptr_t)sT % 16 == 0
                     && (uintptr_t)s0 % 16 == 0;
    if (vec)
      rwkv6_decode<T, true><<<dim3(H, B), DEC_THREADS, 0, stream>>>(
          rp, kp, vp, wp, up, s0p, yp, sp, H, D, Dv);
    else
      rwkv6_decode<T, false><<<dim3(H, B), DEC_THREADS, 0, stream>>>(
          rp, kp, vp, wp, up, s0p, yp, sp, H, D, Dv);
  } else if (form == 1) {
    if (D % vw == 0 && Dv % vw == 0 && aligned)
      return launch_chunked<T, true>(rp, kp, vp, wp, up, s0p, yp, sp, B, Tn,
                                     H, D, Dv, stream);
    return launch_chunked<T, false>(rp, kp, vp, wp, up, s0p, yp, sp, B, Tn,
                                    H, D, Dv, stream);
  } else {
    const bool vec = D % vw == 0 && Dv % vw == 0 && aligned;
    const dim3 grid(H, B, (Dv + COLS - 1) / COLS);
    if (vec)
      rwkv6_prefill<T, true><<<grid, THREADS, 0, stream>>>(
          rp, kp, vp, wp, up, s0p, yp, sp, Tn, H, D, Dv);
    else
      rwkv6_prefill<T, false><<<grid, THREADS, 0, stream>>>(
          rp, kp, vp, wp, up, s0p, yp, sp, Tn, H, D, Dv);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, w: (B, T, H, D); v, y: (B, T, H, Dv); u: (H, D); all contiguous
// and of one type (0 = float32, 1 = bfloat16).  s0 (NULL: zeros) and sT:
// (B, H, D, Dv) float32.  1 <= D, Dv <= 64.  form, for T > 1: 0 the
// sequential prefill, 1 the chunked one (T = 1 takes the decode kernel
// either way).  Returns cudaGetLastError() after launch.
int rwkv6_fwd(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sT, int dtype,
              int form, int B, int Tn, int H, int D, int Dv, void* stream) {
  if (B < 0 || Tn < 1 || H < 0 || D < 1 || D > MAXD || Dv < 1 || Dv > MAXD
      || B > 65535 || H > 65535 || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, y, sT, form, B, Tn, H, D, Dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, form, B, Tn, H, D,
                                 Dv, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
