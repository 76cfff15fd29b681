// Gated linear recurrence (the RG-LRU core) for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::_kernel (launched by
// rglru_scan, pallas_call at :63).  Same function: h_t = a_t h_{t-1} + b_t
// along the time axis of (B, S, D) inputs, channels independent, with an
// optional float32 h0 (zeros without one); every h_t is returned in a's
// type and h_last in float32, as ref.linear_scan and _linear_scan_xla
// return it (the Pallas path returns a's type).  There is no padding, so
// the TPU kernel's "padded steps hold h" guard has nothing to guard: any
// S >= 1 and any D are taken as they are.
//
// What bounds it on the card: one multiply and one add for every three
// elements moved (a and b read, h written), so it is bound by bytes:
// 3 * B * S * D * sizeof(a) over 3.35 TB/s, ~7.3 us at B = 1, S = 1000,
// D = 4096 in bf16 (24.6 MB).  The order of the sums is fixed: the plain
// version (kernels/rglru.py::linear_scan_torch) walks time in sequence in
// float32, rounding the product and the sum separately, and the served
// checks hold the kernel to it bit for bit (recurrentgemma-9b with seeded
// weights flips its argmax under any change of rounding).  So time is
// never split; the parallelism is across channels and the speed comes
// from keeping loads in flight.
//
// Prefill (S > 1), rglru_prefill.  One warp owns 32 consecutive channels
// of one batch row, one lane a channel, h in an f32 register, walking
// time in order; one warp a block, B * ceil(D / 32) blocks (128 at B = 1,
// D = 4096: one an SM).  a and b come through a ring of STAGES stages in
// shared memory, each STEPS steps x 32 channels of both (8 KB: 64 steps
// in bf16, 32 in float32), filled STAGES - 1 stages ahead (24 KB in
// flight a warp) by the tensor memory accelerator: one instruction a
// stage for each of a and b brings a 2-D box of the (B * S, D) tensor,
// and an mbarrier says when it has landed, so the warp spends no
// instructions on addresses or copies.  Rows whose byte stride or base is
// not a multiple of 16, which a tensor map cannot describe, take element
// copies on the same path.  In the step loop each lane reads its
// column of the next AHEAD steps from the ring (64 bytes a row, no bank
// conflict) before their updates, so the dependent chain waits on the
// multiply and the add alone.  A full chunk's h is staged in shared
// memory and leaves as 16-byte stores, so no step spends instructions on
// a global address; the partial last chunk stores each step's row
// directly.  A ragged last warp masks its lanes (the box's columns past D
// arrive as zeros).  What bounds it now: the one warp's step loop, about
// 20 cycles a step, not the card's bytes.  16-byte cp.async copies in
// place of the boxes, more or smaller stages, a TMA store of h, boxes
// shared by two or four warps of a block, and two or four channels a lane
// all measured slower.
//
// Decode (S = 1), rglru_decode.  One thread per (b, channel) over a
// full-width grid, no ring: three loads, one update, two stores.  It has
// no dynamic shared memory, so nothing is set on the function when the
// engine captures the step into a CUDA graph.
//
// Numbers: __fmul_rn then __fadd_rn (no FMA contraction), as the plain
// version's two eager ops round them; bf16 results rounded to nearest
// even; h_last written in float32.
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tiles.cuh"

namespace {

constexpr int LANES = 32;            // channels a warp owns
constexpr int STAGES = 4;            // ring depth
constexpr int STAGE_BYTES = 8192;    // a and b of one stage
constexpr int AHEAD = 16;            // steps read from the ring ahead
constexpr int DECODE_THREADS = 128;

// The ring keeps the inputs' bits: float, or a bf16's 16 bits, which
// widen to float exactly.
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, float>;
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(unsigned short x) {
  return __uint_as_float((unsigned)x << 16);
}
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);     // round to nearest even, as .to() does
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

template <typename T> __device__ __forceinline__ Bits<T> to_bits(float x);
template <> __device__ __forceinline__ float to_bits<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ unsigned short to_bits<__nv_bfloat16>(
    float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// The tensor memory accelerator (TMA): a 2-D box of a tensor map into
// shared memory, its arrival counted by an mbarrier (sm90_tiles.cuh).
using sm90::bar_expect;
using sm90::bar_wait;
using sm90::tma_load;

template <typename T>
struct Ring {
  static constexpr int STEPS = STAGE_BYTES / (2 * LANES * (int)sizeof(T));
  static constexpr int EACH = 16 / (int)sizeof(T);     // elements a store
  static constexpr int PIECES = LANES / EACH;          // stores a row
  static constexpr int ROWS = LANES / PIECES;          // rows a warp store
  alignas(128) Bits<T> a[STAGES][STEPS][LANES];        // TMA boxes
  alignas(128) Bits<T> b[STAGES][STEPS][LANES];
  alignas(16) Bits<T> h[STEPS][LANES];                 // a chunk's h
  uint64_t full[STAGES];                               // a stage landed
};

// Stage `slot` <- steps [0, n) of rows row, row + 1, ... (element (t, c)
// of a at a[(row + t) * D + c]) for channels c0 .. c0 + 31.  TMA: lane 0
// asks for a STEPS x 32 box of each of a and b (rows past the tensor and
// columns past D arrive as zeros; rows past this batch row's S belong to
// the next and go unused); bar_wait(full[slot]) then finds them in
// place.  Element copies: each lane its own column, so no other lane
// reads what it writes.
template <typename T, bool TMA>
__device__ __forceinline__ void fill(Ring<T>& r, int slot,
                                     const CUtensorMap* ma,
                                     const CUtensorMap* mb,
                                     const T* __restrict__ a,
                                     const T* __restrict__ b, size_t row,
                                     int n, int c0, int D, int lane) {
  if constexpr (TMA) {
    if (lane == 0) {
      bar_expect(&r.full[slot], sizeof(r.a[0]) + sizeof(r.b[0]));
      tma_load(r.a[slot], ma, &r.full[slot], c0, (int)row);
      tma_load(r.b[slot], mb, &r.full[slot], c0, (int)row);
    }
  } else {
    const int c = c0 + lane;
    if (c >= D) return;
    const Bits<T>* ap =
        reinterpret_cast<const Bits<T>*>(a) + row * (size_t)D + c;
    const Bits<T>* bp =
        reinterpret_cast<const Bits<T>*>(b) + row * (size_t)D + c;
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      r.a[slot][t][lane] = ap[(size_t)t * D];
      r.b[slot][t][lane] = bp[(size_t)t * D];
    }
  }
}

// A full chunk's h, staged in r.h, out to rows hrow, hrow + D, ... (each
// row's channels c0 .. c0 + 31): 16-byte stores, lane l taking piece
// l % PIECES of rows l / PIECES, + ROWS, ...; or each lane its own
// column.
template <typename T, bool VEC>
__device__ __forceinline__ void drain(const Ring<T>& r, T* __restrict__ hrow,
                                      int c0, int D, int lane) {
  constexpr int STEPS = Ring<T>::STEPS, EACH = Ring<T>::EACH,
                PIECES = Ring<T>::PIECES, ROWS = Ring<T>::ROWS;
  const size_t ld = (size_t)D;
  if constexpr (VEC) {
    const int t0 = lane / PIECES, p = lane % PIECES;
    if (c0 + p * EACH >= D) return;
    T* dst = hrow + t0 * ld + c0 + p * EACH;
#pragma unroll
    for (int j = 0; j < STEPS / ROWS; ++j)
      *reinterpret_cast<uint4*>(dst + j * ROWS * ld) =
          *reinterpret_cast<const uint4*>(&r.h[t0 + j * ROWS][p * EACH]);
  } else {
    const int c = c0 + lane;
    if (c >= D) return;
    Bits<T>* dst = reinterpret_cast<Bits<T>*>(hrow) + c;
#pragma unroll 8
    for (int t = 0; t < STEPS; ++t) dst[t * ld] = r.h[t][lane];
  }
}

template <typename T, bool TMA>
__global__ void __launch_bounds__(LANES)
rglru_prefill(const __grid_constant__ CUtensorMap ma,
              const __grid_constant__ CUtensorMap mb,
              const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ h0, T* __restrict__ h,
              float* __restrict__ h_last, int S, int D) {
  constexpr int STEPS = Ring<T>::STEPS;
  __shared__ __align__(128) Ring<T> ring;
  const int lane = threadIdx.x;
  const int tiles = (D + LANES - 1) / LANES;
  const size_t bi = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x % tiles) * LANES;
  const int c = c0 + lane;
  const bool live = c < D;
  const size_t row0 = bi * (size_t)S;
  const int chunks = (S + STEPS - 1) / STEPS;
  const size_t ld = (size_t)D;

  if (TMA && lane == 0) {
    for (int k = 0; k < STAGES; ++k) sm90::bar_init(&ring.full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < STAGES - 1 && k < chunks; ++k)
    fill<T, TMA>(ring, k, &ma, &mb, a, b, row0 + (size_t)k * STEPS,
                 min(STEPS, S - k * STEPS), c0, D, lane);
  float hv = (h0 != nullptr && live) ? h0[bi * ld + c] : 0.f;
  T* hp = h + row0 * ld + c;

  for (int k = 0; k < chunks; ++k) {
    const int pre = k + STAGES - 1;     // its slot was read at k - 1
    if (pre < chunks)
      fill<T, TMA>(ring, pre % STAGES, &ma, &mb, a, b,
                   row0 + (size_t)pre * STEPS, min(STEPS, S - pre * STEPS),
                   c0, D, lane);
    if (TMA) bar_wait(&ring.full[k % STAGES], (k / STAGES) & 1);
    const Bits<T>(*sa)[LANES] = ring.a[k % STAGES];
    const Bits<T>(*sb)[LANES] = ring.b[k % STAGES];
    const int n = min(STEPS, S - k * STEPS);
    if (n == STEPS) {
      // h goes to shared memory first (no address arithmetic a step),
      // then out as 16-byte rows
#pragma unroll
      for (int g = 0; g < STEPS; g += AHEAD) {
        Bits<T> av[AHEAD], bv[AHEAD];
#pragma unroll
        for (int i = 0; i < AHEAD; ++i) {
          av[i] = sa[g + i][lane];
          bv[i] = sb[g + i][lane];
        }
#pragma unroll
        for (int i = 0; i < AHEAD; ++i) {
          hv = step(to_f(av[i]), hv, to_f(bv[i]));
          ring.h[g + i][lane] = to_bits<T>(hv);
        }
      }
      __syncwarp();
      drain<T, TMA>(ring, h + (row0 + (size_t)k * STEPS) * ld, c0, D, lane);
    } else {
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        hv = step(to_f(sa[t][lane]), hv, to_f(sb[t][lane]));
        if (live) hp[(size_t)t * ld] = from_f<T>(hv);
      }
    }
    hp += (size_t)STEPS * ld;
    __syncwarp();                       // the ring's slot and h are free
  }
  if (live) h_last[bi * ld + c] = hv;
}

template <typename T>
__global__ void __launch_bounds__(DECODE_THREADS)
rglru_decode(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ h,
             float* __restrict__ h_last, long long n) {
  const long long i = (long long)blockIdx.x * DECODE_THREADS + threadIdx.x;
  if (i >= n) return;
  const float hv = step(to_f(a[i]), h0 != nullptr ? h0[i] : 0.f,
                        to_f(b[i]));
  h[i] = from_f<T>(hv);
  h_last[i] = hv;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The (rows, D) row-major tensor at base as TMA boxes of STEPS rows x 32
// channels.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, long long rows, int D) {
  const sm90::EncodeTiled encode = sm90::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {LANES, (cuuint32_t)Ring<T>::STEPS};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(base), dims, stride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* h,
           void* h_last, int B, int S, int D, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const float* h0t = static_cast<const float*>(h0);
  T* ht = static_cast<T*>(h);
  float* hl = static_cast<float*>(h_last);
  if (S == 1) {                         // decode
    const long long n = (long long)B * D;
    const long long blocks = (n + DECODE_THREADS - 1) / DECODE_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rglru_decode<T><<<(unsigned)blocks, DECODE_THREADS, 0, stream>>>(
        at, bt, h0t, ht, hl, n);
    return (int)cudaGetLastError();
  }
  const long long blocks = (long long)B * ((D + LANES - 1) / LANES);
  if (blocks > 0x7fffffffLL || (long long)B * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma{}, mb{};
  // TMA boxes where a tensor map can describe the inputs: rows of a
  // multiple of 16 bytes, a and b on 16-byte boundaries
  if ((D * sizeof(T)) % 16 == 0 && aligned16(a) && aligned16(b)) {
    if (!tensor_map<T>(&ma, a, (long long)B * S, D)
        || !tensor_map<T>(&mb, b, (long long)B * S, D))
      return (int)cudaErrorNotSupported;
    rglru_prefill<T, true><<<(unsigned)blocks, LANES, 0, stream>>>(
        ma, mb, at, bt, h0t, ht, hl, S, D);
  } else {
    rglru_prefill<T, false><<<(unsigned)blocks, LANES, 0, stream>>>(
        ma, mb, at, bt, h0t, ht, hl, S, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, h: (B, S, D) contiguous, of one type (0 = float32, 1 = bfloat16);
// h0: (B, D) float32 or NULL (zeros); h_last: (B, D) float32.  S = 1
// launches the decode kernel, S > 1 the prefill.  Returns
// cudaGetLastError() after launch, or cudaErrorInvalidValue for
// arguments the kernels do not take.
int rglru_fwd(const void* a, const void* b, const void* h0, void* h,
              void* h_last, int dtype, int B, int S, int D, void* stream) {
  if (B < 0 || S < 1 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, h, h_last, B, S, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, S, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
