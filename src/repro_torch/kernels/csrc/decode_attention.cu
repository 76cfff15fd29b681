// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a):
// split-KV (flash-decoding) with the grouped heads on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (launched by decode_attention, pallas_call at :72).  Same function: one
// query token per sequence over a (B, S, Hkv, D) cache with per-sequence
// lengths read on the device and clamped to [0, S]; no cache row at or
// past the length is read (zero-filled in shared memory instead, the
// 0 * NaN guard); f32 softmax state; a length of 0 gives 0, not NaN.
//
// What bounds it on the card: each cached k/v byte is used for ~2 FLOPs
// per query head of its group (~16 FLOP/byte at recurrentgemma-9b's 16
// heads of 256), far below the H100's ~295 FLOP/byte ridge, so it is
// bound by the bytes of the live cache region (2 * sum(lengths) * Hkv * D
// * sizeof(kv)) over 3.35 TB/s.  To reach that rate the cache must be
// read by enough blocks at once, as 16-byte copies kept in flight.
//
// Design.  The TPU grid (b, q_head, kv_tile) carries the online softmax
// across its sequential kv axis.  Here:
// * Pass 1 (split).  The grid is (splits, Hkv x head chunks, B).  Split j
//   owns cache rows [j * chunk, (j + 1) * chunk), chunk a multiple of 64
//   chosen by the wrapper from (B, Hkv, S) and the SM count, never from
//   the lengths (they stay on the device).  A split at or past its
//   sequence's length reads nothing and writes m = -1e30, l = 0, acc = 0.
//   Otherwise it stages its K/V tiles in shared memory in the cache's own
//   type through a two-stage ring of 16-byte cp.async copies (rows past
//   the length zero-filled, never loaded), runs the online softmax over
//   them, and writes f32 partials (m, l, acc[D]) per query head.  With a
//   single split the block writes the output itself.
// * Pass 2 (combine), one block per (b, q-head): rescale each split's
//   partial by exp(m_j - max m), sum, divide by max(l, 1e-30).  A
//   sequence whose splits are all empty gives 0.
// * Grouped heads on the tensor cores (bf16 q and cache, G >= 8, the MQA
//   case): the 16 query heads of a chunk (zero rows pad G < 16) are the A
//   tile; each of the 4 warps owns 16 keys of a 64-key tile and its own
//   online softmax, S = Q.K^T and O += P.V run as mma.sync.m16n8k16 (K by
//   ldmatrix, V by ldmatrix.trans, P split in registers into bf16 hi and
//   lo halves, one mma each, so P keeps ~16 mantissa bits), and
//   the four warps' (m, l, O) merge once at the end of the split.  Rows
//   are padded by 8 elements, so ldmatrix has no bank conflicts.
// * Small groups (G < 8, e.g. stablelm-1.6b's G = 1) and the float32
//   path: CUDA-core f32 math over the same split skeleton and combine.
//   Up to 8 heads a block (the group is cut into chunks of 1/2/4/8); each
//   key is scored by a lane group reading 16 bytes a lane, and the P.V
//   pass gives every thread a 16-byte column slice of V over a strided set
//   of the tile's rows (the slices are summed once, at the end).
// * A cache split by sequence over the ranks of a mesh runs the two
//   passes as entries of their own: decode_attention_partials, the split
//   pass over a rank's chunk of the cache (rows [offset, offset + S) of
//   the sequence, so its live count is clamp(length - offset, 0, S)),
//   writing the partials of every split, one split too; and
//   decode_attention_combine, the combine over any number of partials
//   concatenated on the split axis (a rank's splits times the ranks).
// * The cache's rows may lie further apart than Hkv * D (kv_row): a view
//   of some kv heads of a wider cache, read in place.
// Head sizes 16, 32, 64, 80, 128 and 256 (multiples of 16, for the mma
// tiles); the wrapper zero-pads any other head size up to the next one.
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sm90_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;
constexpr float M_INIT = -1e30f;    // running max before any live key
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part_acc;    // (B, Hq, splits, D), splits > 1 or partials only
  float* part_ml;     // (B, Hq, splits, 2): m, l
  int S, Hq, Hkv, G, splits, chunk;
  int kv_row;         // elements from one cache row to the next
  int offset;         // the cache's first row is sequence position offset
  int partials;       // 1: always write the partials, never the output
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The result of (b, head h) from one split: the output itself when there
// is one split, else the partial of split j.
template <typename TQ>
__device__ __forceinline__ void emit(const Args& a, int b, int h, int j,
                                     int d, int D, float acc, float m,
                                     float l) {
  const size_t bh = (size_t)b * a.Hq + h;
  if (a.splits == 1 && !a.partials) {
    static_cast<TQ*>(a.o)[bh * D + d] = from_f<TQ>(acc / fmaxf(l, 1e-30f));
    return;
  }
  const size_t row = bh * a.splits + j;
  a.part_acc[row * D + d] = acc;
  if (d == 0) {
    a.part_ml[row * 2] = m;
    a.part_ml[row * 2 + 1] = l;
  }
}

template <typename TQ>
__device__ void emit_empty(const Args& a, int b, int h0, int gn, int j,
                           int D) {
  for (int i = threadIdx.x; i < gn * D; i += THREADS)
    emit<TQ>(a, b, h0 + i / D, j, i % D, D, 0.f, M_INIT, 0.f);
}

// ---------------------------------------------------------------------------
// pass 1, CUDA cores: any q/cache type, GC <= 8 heads a block
// ---------------------------------------------------------------------------
// The largest power of two <= 32 dividing a row's CH 16-byte chunks: the
// lanes that score one key (a power of two, so the shuffle sum and the
// 32 / LK keys a warp pass both hold; CH = 20 at D = 80 in float32 gives 4
// lanes of 5 chunks each).
constexpr int lanes_per_key(int ch) {
  int l = 1;
  while (l < 32 && ch % (2 * l) == 0) l *= 2;
  return l;
}

template <typename TKV, int D, int GC>
struct Simt {
  static constexpr int E = 16 / (int)sizeof(TKV);     // elements in 16 B
  static constexpr int CH = D / E;                    // 16 B chunks a row
  static constexpr int BKV = D * (int)sizeof(TKV) > 512 ? 32 : 64;
  static constexpr int LK = lanes_per_key(CH);        // lanes scoring a key
  static constexpr int CPL = CH / LK;                 // chunks a lane
  static constexpr int KPW = 32 / LK;                 // keys a warp pass
  static constexpr int R = THREADS / CH;              // P.V row groups
  // threads past R * CH (when CH does not divide THREADS, e.g. D = 80)
  // take no part in the P.V pass
  static constexpr int STAGE_BYTES = 2 * 2 * BKV * D * (int)sizeof(TKV);
  static constexpr int RED_BYTES = R * GC * D * 4;
  static constexpr int REGION =
      STAGE_BYTES > RED_BYTES ? STAGE_BYTES : RED_BYTES;
  static constexpr int SMEM = REGION + 4 * (GC * D + GC * BKV + 3 * GC);
};

template <typename TQ, typename TKV, int D, int GC>
__global__ void __launch_bounds__(THREADS) split_simt(Args a) {
  using P = Simt<TKV, D, GC>;
  constexpr int E = P::E, CH = P::CH, BKV = P::BKV, LK = P::LK;
  constexpr int CPL = P::CPL, KPW = P::KPW, R = P::R;
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* stage = reinterpret_cast<TKV*>(smem);          // [2][K, V][BKV][D]
  float* red = reinterpret_cast<float*>(smem);        // [R][GC][D], at end
  float* qs = reinterpret_cast<float*>(smem + P::REGION);   // GC x D
  float* ps = qs + GC * D;                            // GC x BKV
  float* ms = ps + GC * BKV;
  float* ls = ms + GC;
  float* as = ls + GC;

  const int j = blockIdx.x, b = blockIdx.z;
  const int chunks = (a.G + GC - 1) / GC;
  const int hk = blockIdx.y / chunks;
  const int g0 = blockIdx.y % chunks * GC;
  const int gn = min(GC, a.G - g0);                   // live heads here
  const int h0 = hk * a.G + g0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(max(a.lengths[b] - a.offset, 0), a.S);
  const int start = j * a.chunk, end = min(start + a.chunk, len);
  if (start >= end) {
    emit_empty<TQ>(a, b, h0, gn, j, D);
    return;
  }

  const TQ* qb = static_cast<const TQ*>(a.q) + ((size_t)b * a.Hq + h0) * D;
  for (int i = tid; i < GC * D; i += THREADS)
    qs[i] = i < gn * D ? to_f(qb[i]) * a.scale : 0.f;
  for (int g = tid; g < GC; g += THREADS) {
    ms[g] = M_INIT;
    ls[g] = 0.f;
  }

  const size_t row = (size_t)a.kv_row;
  const size_t base = (size_t)b * a.S * row + (size_t)hk * D;
  const TKV* kb = static_cast<const TKV*>(a.k) + base;
  const TKV* vb = static_cast<const TKV*>(a.v) + base;
  auto load = [&](int t, int st) {
    TKV* ks = stage + st * 2 * BKV * D;
    TKV* vs = ks + BKV * D;
    const int t0 = start + t * BKV;
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, s = t0 + r;
      const bool ok = s < end;
      const size_t off = (size_t)(ok ? s : start) * row + c * E;
      sm90::cp_async16(ks + r * D + c * E, kb + off, ok);
      sm90::cp_async16(vs + r * D + c * E, vb + off, ok);
    }
  };

  float acc[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  const int cg = tid % CH, rg = tid / CH;             // P.V slice

  const int nt = (end - start + BKV - 1) / BKV;
  load(0, 0);
  sm90::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) load(t + 1, (t + 1) & 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();                // tile t (and q on t = 0) in place
    const TKV* ks = stage + (t & 1) * 2 * BKV * D;
    const TKV* vs = ks + BKV * D;
    const int n = min(BKV, end - start - t * BKV);

    // scores: LK lanes per key, 16 bytes each
    for (int r0 = warp * KPW; r0 < BKV; r0 += 4 * KPW) {
      const int r = r0 + lane / LK, sub = lane % LK;
      float kf[CPL][E];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        load16(ks + r * D + (sub + LK * c) * E, kf[c]);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float qf[E];
#pragma unroll
          for (int e = 0; e < E; e += 4)
            load16(qs + g * D + (sub + LK * c) * E + e, qf + e);
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qf[e], kf[c][e], s);
        }
#pragma unroll
        for (int w = LK / 2; w > 0; w /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, w);
        if (sub == 0) ps[g * BKV + r] = r < n ? s : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < GC; g += THREADS / 32) {
      constexpr int PL = BKV / 32;
      float* pg = ps + g * BKV;
      float sv[PL];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
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
      for (int i = 0; i < PL; ++i) {
        const float p = expf(sv[i] - m_new);
        pg[lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        as[g] = al;
        ls[g] = ls[g] * al + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: a 16-byte column slice of V over rows rg, rg + R, ...
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float al = as[g];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= al;
    }
    for (int r = rg; rg < R && r < n; r += R) {
      float vf[E];
      load16(vs + r * D + cg * E, vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = ps[g * BKV + r];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();                // stage t & 1 free for tile t + 2
  }
  sm90::cp_async_wait<0>();         // the last (empty) group
  __syncthreads();

  if (rg < R) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e)
        red[(rg * GC + g) * D + cg * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) s += red[(r * GC + g) * D + d];
    emit<TQ>(a, b, h0 + g, j, d, D, s, ms[g], ls[g]);
  }
}

// ---------------------------------------------------------------------------
// pass 1, tensor cores: bf16 q and cache, 16 heads a block (G >= 8)
// ---------------------------------------------------------------------------
template <int D>
struct Mma {
  static constexpr int BKV = 64;                      // 16 keys a warp
  static constexpr int LD = D + 8;                    // padded row
  static constexpr int CH = D / 8;                    // 16 B chunks a row
  static constexpr int STAGE_BYTES = 2 * 2 * BKV * LD * 2;
  static constexpr int RED_BYTES = 4 * 16 * (D + 2) * 4;
  static constexpr int REGION =
      STAGE_BYTES > RED_BYTES ? STAGE_BYTES : RED_BYTES;
  static constexpr int SMEM = REGION + 16 * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(THREADS) split_mma(Args a) {
  using P = Mma<D>;
  constexpr int BKV = P::BKV, LD = P::LD, CH = P::CH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);        // [2][K, V][BKV][LD]
  float* red = reinterpret_cast<float*>(smem);        // [4][16 x D, m, l]
  bf16* qs = reinterpret_cast<bf16*>(smem + P::REGION);   // 16 x LD

  const int j = blockIdx.x, b = blockIdx.z;
  const int chunks = (a.G + 15) / 16;
  const int hk = blockIdx.y / chunks;
  const int g0 = blockIdx.y % chunks * 16;
  const int gn = min(16, a.G - g0);
  const int h0 = hk * a.G + g0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(max(a.lengths[b] - a.offset, 0), a.S);
  const int start = j * a.chunk, end = min(start + a.chunk, len);
  if (start >= end) {
    emit_empty<bf16>(a, b, h0, gn, j, D);
    return;
  }

  const bf16* qb = static_cast<const bf16*>(a.q) + ((size_t)b * a.Hq + h0) * D;
  for (int i = tid; i < 16 * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    sm90::cp_async16(qs + r * LD + c * 8, qb + (r < gn ? r : 0) * D + c * 8,
                     r < gn);
  }
  const size_t row = (size_t)a.kv_row;
  const size_t base = (size_t)b * a.S * row + (size_t)hk * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + base;
  const bf16* vb = static_cast<const bf16*>(a.v) + base;
  auto load = [&](int t, int st) {
    bf16* ks = stage + st * 2 * BKV * LD;
    bf16* vs = ks + BKV * LD;
    const int t0 = start + t * BKV;
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, s = t0 + r;
      const bool ok = s < end;
      const size_t off = (size_t)(ok ? s : start) * row + c * 8;
      sm90::cp_async16(ks + r * LD + c * 8, kb + off, ok);
      sm90::cp_async16(vs + r * LD + c * 8, vb + off, ok);
    }
  };

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};   // rows lane/4, +8
  const float sl2 = a.scale * LOG2E;                  // exp2 domain
  const int kw = warp * 16;                           // this warp's keys

  const int nt = (end - start + BKV - 1) / BKV;
  load(0, 0);
  sm90::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) load(t + 1, (t + 1) & 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = stage + (t & 1) * 2 * BKV * LD;
    const bf16* vs = ks + BKV * LD;
    const int live = end - start - t * BKV - kw;      // of this warp's 16
    if (live > 0) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t qa[4], kf[4];
        sm90::ldmatrix_x4(qa, qs + (lane & 15) * LD + k0 + (lane >> 4) * 8);
        sm90::ldmatrix_x4(kf, ks + (kw + (lane & 7) + (lane >> 4) * 8) * LD
                                  + k0 + ((lane >> 3) & 1) * 8);
        sm90::mma_bf16(s[0], qa, kf[0], kf[1]);
        sm90::mma_bf16(s[1], qa, kf[2], kf[3]);
      }
      float p[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = n * 8 + 2 * (lane % 4) + c;
            float& x = s[n][2 * rr + c];
            x = key < live ? x * sl2 : -CUDART_INF_F;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        const float al = exp2f(m[rr] - m_new);
        m[rr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            p[n][2 * rr + c] = exp2f(s[n][2 * rr + c] - m_new);
            sum += p[n][2 * rr + c];
          }
        l[rr] = l[rr] * al + sum;     // this thread's columns; quad sum at end
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * rr] *= al;
          o[n][2 * rr + 1] *= al;
        }
      }
      uint32_t hi[4], lo[4];          // P = hi + lo, two bf16 fragments
      sm90::split_bf16(p[0][0], p[0][1], hi[0], lo[0]);
      sm90::split_bf16(p[0][2], p[0][3], hi[1], lo[1]);
      sm90::split_bf16(p[1][0], p[1][1], hi[2], lo[2]);
      sm90::split_bf16(p[1][2], p[1][3], hi[3], lo[3]);
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        uint32_t vf[4];
        sm90::ldmatrix_x4_trans(
            vf, vs + (kw + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0
                    + (lane >> 4) * 8);
        sm90::mma_bf16(o[n0 / 8], hi, vf[0], vf[1]);
        sm90::mma_bf16(o[n0 / 8 + 1], hi, vf[2], vf[3]);
        sm90::mma_bf16(o[n0 / 8], lo, vf[0], vf[1]);
        sm90::mma_bf16(o[n0 / 8 + 1], lo, vf[2], vf[3]);
      }
    }
    __syncthreads();
  }
  sm90::cp_async_wait<0>();
  __syncthreads();

  // merge the four warps' (m, l, O)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  float* rw = red + warp * 16 * (D + 2);
  const int gr = lane / 4, gc = 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    rw[gr * D + n * 8 + gc] = o[n][0];
    rw[gr * D + n * 8 + gc + 1] = o[n][1];
    rw[(gr + 8) * D + n * 8 + gc] = o[n][2];
    rw[(gr + 8) * D + n * 8 + gc + 1] = o[n][3];
  }
  if (lane % 4 == 0) {
    rw[16 * D + gr] = m[0];
    rw[16 * D + gr + 8] = m[1];
    rw[16 * D + 16 + gr] = l[0];
    rw[16 * D + 16 + gr + 8] = l[1];
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mw[4], M = M_INIT;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      mw[w] = red[w * 16 * (D + 2) + 16 * D + g];
      M = fmaxf(M, mw[w]);
    }
    float acc = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* rw2 = red + w * 16 * (D + 2);
      const float sc = exp2f(mw[w] - M);
      acc += rw2[g * D + d] * sc;
      L += rw2[16 * D + 16 + g] * sc;
    }
    emit<bf16>(a, b, h0 + g, j, d, D, acc, M * LN2, L);  // m back to base e
  }
}

// ---------------------------------------------------------------------------
// pass 2: combine the splits of one (b, q-head); D threads
// ---------------------------------------------------------------------------
template <typename TQ>
__global__ void combine(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml, TQ* __restrict__ o,
                        int splits) {
  const int D = blockDim.x, d = threadIdx.x;
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float M = M_INIT;
  for (int j = 0; j < splits; ++j) M = fmaxf(M, ml[2 * j]);
  float acc = 0.f, L = 0.f;
  for (int j = 0; j < splits; ++j) {
    const float w = expf(ml[2 * j] - M);   // empty split: exp(-1e30 - M) = 0
    L += ml[2 * j + 1] * w;
    acc += part_acc[(bh * splits + j) * D + d] * w;
  }
  o[bh * D + d] = from_f<TQ>(acc / fmaxf(L, 1e-30f));
}

template <typename Kernel>
int launch_split(Kernel kernel, int smem, unsigned& done, dim3 grid,
                 const Args& a, cudaStream_t stream) {
  cudaError_t err = sm90::set_smem_once(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int D, int GC>
int launch_simt(const Args& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  const dim3 grid(a.splits, a.Hkv * ((a.G + GC - 1) / GC), B);
  return launch_split(split_simt<TQ, TKV, D, GC>, Simt<TKV, D, GC>::SMEM,
                      done, grid, a, stream);
}

template <int D>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  const dim3 grid(a.splits, a.Hkv * ((a.G + 15) / 16), B);
  return launch_split(split_mma<D>, Mma<D>::SMEM, done, grid, a, stream);
}

template <typename TQ, typename TKV, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  int err;
  if (std::is_same<TQ, bf16>::value && std::is_same<TKV, bf16>::value
      && a.G >= 8)
    err = launch_mma<D>(a, B, stream);
  else if (a.G >= 8)
    err = launch_simt<TQ, TKV, D, 8>(a, B, stream);
  else if (a.G >= 4)
    err = launch_simt<TQ, TKV, D, 4>(a, B, stream);
  else if (a.G >= 2)
    err = launch_simt<TQ, TKV, D, 2>(a, B, stream);
  else
    err = launch_simt<TQ, TKV, D, 1>(a, B, stream);
  if (err != 0 || a.splits == 1 || a.partials) return err;
  combine<TQ><<<dim3(a.Hq, B), D, 0, stream>>>(a.part_acc, a.part_ml,
                                               static_cast<TQ*>(a.o),
                                               a.splits);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<TQ, TKV, 16>(a, B, stream);
    case 32: return launch<TQ, TKV, 32>(a, B, stream);
    case 64: return launch<TQ, TKV, 64>(a, B, stream);
    case 80: return launch<TQ, TKV, 80>(a, B, stream);
    case 128: return launch<TQ, TKV, 128>(a, B, stream);
    case 256: return launch<TQ, TKV, 256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, 1, Hq, D); k, v: (B, S, Hkv, D) with rows kv_row elements apart
// (kv_row >= Hkv * D: a view of some heads of a wider cache), a batch row
// S * kv_row; lengths: (B,) int32 on the device; o: (B, 1, Hq, D) of q's
// type; 16-byte aligned.  dtypes: 0 = float32, 1 = bfloat16.  splits >= 1
// blocks per (b, kv-head chunk), split j owning cache rows [j * chunk,
// (j + 1) * chunk), chunk a multiple of 64; with splits > 1, part_acc
// (B * Hq * splits * D floats) and part_ml (B * Hq * splits * 2) are the
// wrapper's scratch.  Launches the split pass and, for splits > 1, the
// combine.  Returns cudaGetLastError() after the launches.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, void* part_acc,
                         void* part_ml, int q_dtype, int kv_dtype, int B,
                         int S, int Hq, int Hkv, int D, int splits, int chunk,
                         int kv_row, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || splits < 1 || chunk < 1 || chunk % 64
      || kv_row < Hkv * D
      || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{q, k, v, static_cast<const int*>(lengths), o,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               S, Hq, Hkv, Hq / Hkv, splits, chunk, kv_row, 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch_d<float, float>(a, B, D, s);
  if (q_dtype == 0 && kv_dtype == 1) return launch_d<float, bf16>(a, B, D, s);
  if (q_dtype == 1 && kv_dtype == 0) return launch_d<bf16, float>(a, B, D, s);
  if (q_dtype == 1 && kv_dtype == 1) return launch_d<bf16, bf16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}

// The split pass alone, over a chunk of a sequence-split cache: k and v
// hold sequence positions [offset, offset + S), so sequence b's live rows
// here are the first clamp(lengths[b] - offset, 0, S).  Every split writes
// its f32 partials (m, l, acc) to part_ml (B, Hq, splits, 2) and part_acc
// (B, Hq, splits, D), one split too; a split with no live row writes m =
// -1e30, l = 0, acc = 0.  The other arguments are decode_attention_fwd's.
int decode_attention_partials(const void* q, const void* k, const void* v,
                              const void* lengths, void* part_acc,
                              void* part_ml, int q_dtype, int kv_dtype, int B,
                              int S, int Hq, int Hkv, int D, int splits,
                              int chunk, int kv_row, int offset, float scale,
                              void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || splits < 1 || chunk < 1 || chunk % 64
      || kv_row < Hkv * D || part_acc == nullptr || part_ml == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{q, k, v, static_cast<const int*>(lengths), nullptr,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               S, Hq, Hkv, Hq / Hkv, splits, chunk, kv_row, offset, 1, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch_d<float, float>(a, B, D, s);
  if (q_dtype == 0 && kv_dtype == 1) return launch_d<float, bf16>(a, B, D, s);
  if (q_dtype == 1 && kv_dtype == 0) return launch_d<bf16, float>(a, B, D, s);
  if (q_dtype == 1 && kv_dtype == 1) return launch_d<bf16, bf16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}

// The combine pass alone: o (B, 1, Hq, D) of o_dtype's type from J
// partials a (b, head), laid out as decode_attention_partials writes them
// (several calls' partials concatenated on the J axis: a rank's splits
// times the ranks).  Returns cudaGetLastError() after the launch.
int decode_attention_combine(const void* part_acc, const void* part_ml,
                             void* o, int o_dtype, int B, int Hq, int D,
                             int J, void* stream) {
  if (J < 1 || D < 1 || D > 1024) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return 0;
  const float* acc = static_cast<const float*>(part_acc);
  const float* ml = static_cast<const float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o_dtype == 0)
    combine<float><<<dim3(Hq, B), D, 0, s>>>(acc, ml, static_cast<float*>(o),
                                             J);
  else if (o_dtype == 1)
    combine<bf16><<<dim3(Hq, B), D, 0, s>>>(acc, ml, static_cast<bf16*>(o),
                                            J);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
