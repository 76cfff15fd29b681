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
// Rounding: the plain version's, bit for bit.  Every product and sum of
// the state update and of the terms r_i (S_ij + u_i k_i v_j) is rounded on
// its own (__fmul_rn, __fadd_rn: no FMA contraction), as the eager ops of
// kernels/rwkv6.py::rwkv6_torch round them, and the 64 terms of y_j (D
// padded with zeros, which add exactly nothing) are summed by halving,
// term_i + term_{i+h} for h = 32, 16, ..., 1, the order in which the plain
// version sums them.  Equal bits are a design choice, not a convenience:
// rwkv6-7b with seeded random weights turns any change of rounding into a
// change of its bf16 logits as large as the port's float32 oracle shows
// against the plain path (9-16%, the floor chip_smoke.py prints), and
// where the plain path's top two logits lie a small fraction of a
// standard deviation apart the argmax flips.  A kernel that reorders the
// sums (a chunked form on the tensor cores, even with its bf16 operands
// split in two or three) cannot be told from a faulty one by the served
// checks; this one is held to them exactly.
//
// Work and bound: 4 D Dv FLOP per (b, t, h), the function's own (r^T S and
// the rank-1 update), 1.05 GFLOP at a prefill of B = 1, T = 1000, H = 64,
// D = Dv = 64; that fits the bf16 tensor cores in ~1 us, so the 43 MB of
// r, k, v, w, y and both states bound the function (12.9 us at 3.35
// TB/s).  This kernel spends 7 rounded float32 operations per (t, i, j)
// on the CUDA cores instead, 1.8 G of them at that shape (~55 us at the
// card's 128 lanes x 132 SMs at 1.98 GHz), and every thread reads the
// step's r, k and w of its channels from shared memory: issue and those
// reads, not the bytes, are what it runs into.  At a decode step (B = 4,
// T = 1) the 8.4 MB of float32 state read and written bind (2.5 us).
//
// Prefill (T > 1): rwkv6_prefill.  The columns of S evolve independently,
// and within a column the halving sum splits by channel residue: sixteen
// lanes own a column, lane c the channels c, c + 16, c + 32, c + 48, and
// each thread two columns (the step's r, k, w serve both).  A thread sums
// its 4 terms of a column in registers (the levels h = 32, 16 pair its own
// channels); the levels h = 8, 4, 2, 1 pair lanes c and c ^ h, and run
// once a chunk of 16 steps for all of them together: at each level a lane
// keeps half the steps, adds its partner's share of those and hands over
// its own share of the rest (15 shuffles a column per chunk, not 64), so
// lane c ends with step c, summed in the plain version's order.  Block
// (h, b, z) owns columns 16z .. 16z + 15 with 128 threads, and B = 1, H =
// 64, Dv = 64 runs 256 blocks, two on each of 124 SMs.  Each chunk's r, k,
// w (converted to float32, residue-major so a lane's 4 channels are one
// 16-byte read, rows 4 banks apart) and its v columns are staged in
// shared memory; they arrive as 16-byte loads where D, Dv and the pointers
// allow, else element by element; two chunks are in flight, chunk n + 2
// loading into registers while chunk n runs and chunk n + 1 waits in the
// other buffer, and a chunk is converted only when it is staged, so no
// instruction waits on a load while the products run.  y leaves through
// shared memory a chunk at a time.  Steps past T in the last chunk carry r
// = k = v = 0 and w = 1, which leave S as it is (1 * S + 0 = S), and write
// no y.
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

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B, int Tn,
           int H, int D, int Dv, cudaStream_t stream) {
  const T *rp = static_cast<const T*>(r), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *wp = static_cast<const T*>(w),
          *up = static_cast<const T*>(u);
  const float* s0p = static_cast<const float*>(s0);
  T* yp = static_cast<T*>(y);
  float* sp = static_cast<float*>(sT);
  if (Tn == 1) {
    const bool vec = Dv % 4 == 0 && (uintptr_t)sT % 16 == 0
                     && (uintptr_t)s0 % 16 == 0;
    if (vec)
      rwkv6_decode<T, true><<<dim3(H, B), DEC_THREADS, 0, stream>>>(
          rp, kp, vp, wp, up, s0p, yp, sp, H, D, Dv);
    else
      rwkv6_decode<T, false><<<dim3(H, B), DEC_THREADS, 0, stream>>>(
          rp, kp, vp, wp, up, s0p, yp, sp, H, D, Dv);
  } else {
    constexpr int vw = 16 / sizeof(T);
    const bool vec = D % vw == 0 && Dv % vw == 0
                     && ((uintptr_t)r | (uintptr_t)k | (uintptr_t)w
                         | (uintptr_t)v) % 16 == 0;
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
