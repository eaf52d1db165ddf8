// One-pass fused GLM evaluation kernels for Hopper (sm_90a).
//
// K1 `vg_kernel` replaces the Pallas kernel `_vg_kernel`
// (photon_ml_tpu/ops/fused.py, launched there by `fused_value_grad`): one
// read of X gives (sum_i w_i l(m_i, y_i), X^T r, sum_i r_i) with
// r = w * l'(m, y) and margins m = X u + offsets - c.
// K2 `hvp_kernel` replaces `_hvp_kernel` (launched by `fused_hvp`): one read
// of X gives (X^T q, sum_i q_i) with q = w * l''(m, y) * (X v - cv).
//
// Bound on an H100 SXM: both read X once and everything else is O(n + d),
// so they are bound by the bytes of X over the 3.35 TB/s of device memory:
// 0.32 ms for X of 1 GiB (n = 2^20, d = 512 in bf16, or d = 256 in f32:
// K1 at the headline and config B, K2 at config B), 0.041 ms for K2 at B's
// streamed chunk (2^17 x 256 f32, with labels, offsets and weights). The
// arithmetic (4 n d flops for K1, 6 n d for K2, plus 3 n d for the
// compensated sums below, in float32 on the CUDA cores at 67 TFLOP/s) stays
// under a fifth of that time.
//
// What the design does about the bound: X is read exactly once per
// evaluation, as data first to evict from L2, and nothing per row goes back
// to device memory. K1 has two layouts, chosen by shape and alignment only
// (`vg_launch`); K2 has the first. At a 2^17-row chunk a call's host cost is
// as large as the card's work, so the launch path asks the device nothing
// after its first call (`LaunchCache`: SM count, resident blocks and the
// shared-memory limit kept per instantiation and device) and takes c and cv
// from the caller's tensors on the card or by value, with no tensor built
// for them.
//
// Rows layout (`vg_kernel`, `hvp_kernel`): a warp owns one row at a time:
// its lanes load the row in 16-byte vectors where the row is 16-byte aligned
// (lane l holds vectors l, l + 32, ...; scalars otherwise), form the margin
// dot (and, in K2, the dot with v from the same registers), reduce it with a
// butterfly so every lane holds the same bits, apply the loss in registers,
// and add r * x (or q * x) into per-lane column accumulators. Where a lane
// holds at most 16 columns, each warp loads two rows before it reduces
// either, to keep more bytes in flight. Neither the margins nor r / q are
// ever stored. At the headline and config B this reaches 60% and 85-90% of
// the bytes bound. On narrow rows it is bound by instruction issue instead:
// at d = 65 float32 (GAME's fixed effect) a 260-byte row is not 16-byte
// aligned, each lane runs 8 predicated scalar columns of which 65 of 256
// exist, and the butterfly and the loss run 32 times a row -- about 100
// warp instructions a row against some 74 issue slots a row at the bound.
// K2 runs only at config B's width (256 float32), where a layout of staged
// row tiles with several threads a row and its blocks summed in the same
// launch measured no faster than this one (PERF.md), so K2 keeps this one.
//
// Tiles layout (`vg_tiles_kernel`, K1 only; d <= kTilesMaxFeatures* and X,
// labels, offsets and weights 16-byte aligned): a block walks over tiles of
// R consecutive rows (`tile_plan`). R rows of X are contiguous whatever d
// is, so one bulk copy (cp.async.bulk, completing on an mbarrier) brings a
// tile's X rows into a stage of a ring in shared memory, and three more its
// labels, offsets and weights; R is a multiple of 32, so every copy starts
// 16-byte aligned. Thread 0 keeps the ring's other stages in flight while
// the block computes on one. One thread per row forms the margin from the
// staged row and u (in shared memory), evaluates the loss once and leaves r
// in shared memory; a row read at a stride of d words would put a warp on
// one bank at even d, so each thread starts its dot at a rotated column.
// Then P = kThreads / d partitions of d threads each sum their column over
// every P-th row of the tile, reading consecutive words. That is about 20
// warp instructions a row at d = 65 float32, so the copies, not issue,
// bound it. A partial last tile comes in by plain loads.
//
// Determinism and accuracy: no float atomics. Rows layout: each warp keeps
// compensated (Kahan) float32 sums over its rows; the warps of a block add
// theirs in warp order into float64 slots. Tiles layout: each row thread
// keeps compensated value and r sums over its rows; each column owner sums
// a tile's rows in plain float32 (at most R / P terms, 75 at d = 65
// float32; bfloat16 in two interleaved partial sums) and adds that to its
// compensated sum over tiles; the block adds
// the owners' sums in partition order and the scalars by a fixed tree into
// float64 slots. Either way each block writes its own row of a
// (grid, C) float64 partial array (C = d + 2 for K1: gradient, value,
// r-sum; C = d + 1 for K2: Hv, q-sum), and a second kernel sums each
// column over the blocks in float64 with a fixed-shape tree, rounding once
// to float32. The grid is a function of the device, the shapes and the
// instantiation only, so results repeat bitwise from run to run, and the
// sums over a million rows stay within a few float32 roundings of exact (a
// running float32 accumulator across tiles stalled the optimizer's Armijo
// test near convergence in the reference; see fused.py there).
//
// Precision: float32 storage is full float32 FMA. bfloat16 storage rounds u
// (and v) to bfloat16 before the margin dot and r (and q) to bfloat16 before
// the transposed product, accumulating in float32 (products of two bfloat16
// values are exact in float32) -- the places the reference rounds.
//
// Masking: rows >= n are never loaded or copied; where weights are given, a
// zero weight makes the row contribute exactly 0 through a select, so a
// Poisson exp overflow on a padded row cannot become NaN. A null `off` / `wt`
// pointer means offsets 0 / weights 1 and the array is not read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "ring.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kReduceThreads = 256;
constexpr int kMaxFeatures = 1024;  // 32 lanes x at most 32 columns each

// Must agree with `PointwiseLoss.kernel_id` in ops/losses.py.
enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

template <int L>
struct Loss;

template <>
struct Loss<kLogistic> {
  __device__ static float value(float m, float y) {
    const float x = -(2.f * y - 1.f) * m;
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // stable softplus
  }
  __device__ static float d1(float m, float y) { return 1.f / (1.f + expf(-m)) - y; }
  __device__ static float d2(float m, float) {
    const float p = 1.f / (1.f + expf(-m));
    return p * (1.f - p);
  }
};

template <>
struct Loss<kSquared> {
  __device__ static float value(float m, float y) {
    const float e = m - y;
    return 0.5f * (e * e);
  }
  __device__ static float d1(float m, float y) { return m - y; }
  __device__ static float d2(float, float) { return 1.f; }
};

template <>
struct Loss<kPoisson> {
  __device__ static float value(float m, float y) { return expf(m) - y * m; }
  __device__ static float d1(float m, float y) { return expf(m) - y; }
  __device__ static float d2(float m, float) { return expf(m); }
};

template <>
struct Loss<kSmoothedHinge> {
  __device__ static float value(float m, float y) {
    const float z = (2.f * y - 1.f) * m;
    if (z <= 0.f) return 0.5f - z;
    if (z < 1.f) return 0.5f * ((1.f - z) * (1.f - z));
    return 0.f;
  }
  __device__ static float d1(float m, float y) {
    const float s = 2.f * y - 1.f;
    const float z = s * m;
    const float dz = z <= 0.f ? -1.f : (z < 1.f ? z - 1.f : 0.f);
    return s * dz;
  }
  __device__ static float d2(float m, float y) {
    const float z = (2.f * y - 1.f) * m;
    return (z > 0.f && z < 1.f) ? 1.f : 0.f;
  }
};

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);  // exact
}

// VEC consecutive elements of X at p, widened to float, as one load.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* o) { o[0] = __ldcs(p); }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* o) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    o[0] = bf16_bits_to_float(__ldcs(reinterpret_cast<const unsigned short*>(p)));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[2 * k] = __uint_as_float(w[k] << 16);
      o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A scalar argument: the caller's float32 on the card where `p` is given,
// else the value passed with the launch.
__device__ __forceinline__ float scalar(const float* p, float value) {
  return p != nullptr ? *p : value;
}

// Lane `lane` holds columns (k * 32 + lane) * VEC + e, k < NV, e < VEC.
// With VEC > 1 the wrapper guarantees d % VEC == 0, so a vector lies wholly
// inside or wholly outside the row.
template <typename T, int VEC, int NV>
__device__ __forceinline__ void load_row(const T* row, int d, int lane, float (&x)[NV * VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = (k * 32 + lane) * VEC;
    if (j < d) {
      Vec<T, VEC>::load(row + j, &x[k * VEC]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[k * VEC + e] = 0.f;
    }
  }
}

// The lane's columns of a float32 vector, rounded to bfloat16 for bfloat16 X.
template <bool kBf16, int VEC, int NV>
__device__ __forceinline__ void load_vector(const float* v, int d, int lane, float (&o)[NV * VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int j = (k * 32 + lane) * VEC + e;
      const float vj = j < d ? v[j] : 0.f;
      o[k * VEC + e] = kBf16 ? round_bf16(vj) : vj;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: float addition is commutative, so every lane ends with
  // the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Compensated (Kahan) running sum of a * b: s - c carries the sum to about
// one rounding, however many rows a warp adds.
__device__ __forceinline__ void kahan_fma(float& s, float& c, float a, float b) {
  const float y = fmaf(a, b, -c);
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Add this warp's compensated sums into the block's float64 slots (columns
// j < d from their lanes, the scalars from lane 0). Warps add one at a time,
// in warp order, so the block's sums are fixed.
template <int VEC, int NV, int NS>
__device__ __forceinline__ void add_warp_sums(double* slots, int d, int lane, int warp,
                                              const float (&s)[NV * VEC],
                                              const float (&c)[NV * VEC],
                                              const float (&ss)[NS], const float (&sc)[NS]) {
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int j = (k * 32 + lane) * VEC + e;
          const double v = static_cast<double>(s[k * VEC + e]) - c[k * VEC + e];
          if (j < d) slots[j] = (w == 0 ? 0.0 : slots[j]) + v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          const double v = static_cast<double>(ss[t]) - sc[t];
          slots[d + t] = (w == 0 ? 0.0 : slots[d + t]) + v;
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void write_block_partial(const double* slots, int C, double* part) {
  for (int j = threadIdx.x; j < C; j += kThreads) {
    part[static_cast<long long>(blockIdx.x) * C + j] = slots[j];
  }
}

// Per-row step of K1 on a row held in registers; sums[0] / sums[1] are the
// value and r sums, comps their compensations.
template <int L, bool kBf16, int E>
__device__ __forceinline__ void vg_row(const float (&x)[E], const float (&ur)[E], long long i,
                                       float c, const float* __restrict__ y,
                                       const float* __restrict__ off,
                                       const float* __restrict__ wt, float (&acc)[E],
                                       float (&cmp)[E], float (&sums)[2], float (&comps)[2]) {
  float dot = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) dot = fmaf(x[e], ur[e], dot);
  float m = warp_sum(dot) - c;
  if (off != nullptr) m += off[i];
  const float yi = y[i];
  float lv = Loss<L>::value(m, yi);
  float r = Loss<L>::d1(m, yi);
  if (wt != nullptr) {
    const float w = wt[i];
    lv = w != 0.f ? w * lv : 0.f;
    r = w != 0.f ? w * r : 0.f;
  }
  kahan_fma(sums[0], comps[0], lv, 1.f);
  kahan_fma(sums[1], comps[1], r, 1.f);
  const float rb = kBf16 ? round_bf16(r) : r;
#pragma unroll
  for (int e = 0; e < E; ++e) kahan_fma(acc[e], cmp[e], rb, x[e]);
}

// Per-row step of K2; sums[0] is the q sum.
template <int L, bool kBf16, int E>
__device__ __forceinline__ void hvp_row(const float (&x)[E], const float (&ur)[E],
                                        const float (&vr)[E], long long i, float c, float cv,
                                        const float* __restrict__ y,
                                        const float* __restrict__ off,
                                        const float* __restrict__ wt, float (&acc)[E],
                                        float (&cmp)[E], float (&sums)[1], float (&comps)[1]) {
  float du = 0.f, dv = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    du = fmaf(x[e], ur[e], du);
    dv = fmaf(x[e], vr[e], dv);
  }
  float m = warp_sum(du) - c;
  if (off != nullptr) m += off[i];
  const float mv = warp_sum(dv) - cv;
  float d2 = Loss<L>::d2(m, y[i]);
  if (wt != nullptr) {
    const float w = wt[i];
    d2 = w != 0.f ? w * d2 : 0.f;
  }
  const float q = d2 * mv;
  kahan_fma(sums[0], comps[0], q, 1.f);
  const float qb = kBf16 ? round_bf16(q) : q;
#pragma unroll
  for (int e = 0; e < E; ++e) kahan_fma(acc[e], cmp[e], qb, x[e]);
}

// Warp w of the grid takes rows w, w + W, w + 2W, ... (W warps in all). With
// at most 16 columns per lane it loads two rows before it reduces either,
// to keep more bytes in flight; wider rows take one at a time (registers).
// `step(x, i)` runs the per-row work on row i held in x.
template <typename T, int VEC, int NV, typename Step>
__device__ __forceinline__ void for_each_row(const T* __restrict__ X, long long n, int d,
                                             int lane, int warp, Step step) {
  constexpr int E = NV * VEC;
  const long long W = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if constexpr (E <= 16) {
    for (long long i = first; i < n; i += 2 * W) {
      const long long i1 = i + W;
      float x0[E], x1[E];
      load_row<T, VEC, NV>(X + i * d, d, lane, x0);
      if (i1 < n) load_row<T, VEC, NV>(X + i1 * d, d, lane, x1);
      step(x0, i);
      if (i1 < n) step(x1, i1);
    }
  } else {
    for (long long i = first; i < n; i += W) {
      float x0[E];
      load_row<T, VEC, NV>(X + i * d, d, lane, x0);
      step(x0, i);
    }
  }
}

// K1. part: (gridDim.x, d + 2) float64 = [X^T r | sum w l | sum r] per block.
template <typename T, int L, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
    vg_kernel(const T* __restrict__ X, const float* __restrict__ y,
              const float* __restrict__ off, const float* __restrict__ wt,
              const float* __restrict__ u, const float* __restrict__ cp, float cval,
              long long n, int d, double* __restrict__ part) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int E = NV * VEC;
  extern __shared__ double slots[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ur[E], acc[E], cmp[E];
  load_vector<kBf16, VEC, NV>(u, d, lane, ur);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = cmp[e] = 0.f;
  const float c = scalar(cp, cval);
  float sums[2] = {0.f, 0.f}, comps[2] = {0.f, 0.f};

  for_each_row<T, VEC, NV>(X, n, d, lane, warp, [&](const float (&x)[E], long long i) {
    vg_row<L, kBf16, E>(x, ur, i, c, y, off, wt, acc, cmp, sums, comps);
  });

  add_warp_sums<VEC, NV, 2>(slots, d, lane, warp, acc, cmp, sums, comps);
  write_block_partial(slots, d + 2, part);
}

// K2. part: (gridDim.x, d + 1) float64 = [X^T q | sum q] per block.
template <typename T, int L, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
    hvp_kernel(const T* __restrict__ X, const float* __restrict__ y,
               const float* __restrict__ off, const float* __restrict__ wt,
               const float* __restrict__ u, const float* __restrict__ v,
               const float* __restrict__ cp, const float* __restrict__ cvp, float cval,
               float cvval, long long n, int d, double* __restrict__ part) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int E = NV * VEC;
  extern __shared__ double slots[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ur[E], vr[E], acc[E], cmp[E];
  load_vector<kBf16, VEC, NV>(u, d, lane, ur);
  load_vector<kBf16, VEC, NV>(v, d, lane, vr);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = cmp[e] = 0.f;
  const float c = scalar(cp, cval);
  const float cv = scalar(cvp, cvval);
  float sums[1] = {0.f}, comps[1] = {0.f};

  for_each_row<T, VEC, NV>(X, n, d, lane, warp, [&](const float (&x)[E], long long i) {
    hvp_row<L, kBf16, E>(x, ur, vr, i, c, cv, y, off, wt, acc, cmp, sums, comps);
  });

  add_warp_sums<VEC, NV, 1>(slots, d, lane, warp, acc, cmp, sums, comps);
  write_block_partial(slots, d + 1, part);
}

// out[j] = the float32 rounding of the sum over the G block slots of column
// j, summed in float64 as a fixed-shape tree.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials(const double* __restrict__ part, int G, int C, float* __restrict__ out) {
  __shared__ double s[kReduceThreads];
  const int j = blockIdx.x;
  double a = 0.0;
  for (int g = threadIdx.x; g < G; g += kReduceThreads) a += part[static_cast<long long>(g) * C + j];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int o = kReduceThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = static_cast<float>(s[0]);
}

// ---------------------------------------------------------------------------
// K1, tiles layout (narrow rows)
// ---------------------------------------------------------------------------

// Must agree with `VgPlan` / `vg_plan` in ops/fused.py.
enum VgLayout { kLayoutAuto = -1, kLayoutRows = 0, kLayoutTiles = 1 };
// The widest rows the tiles layout takes by the rule, per storage type.
// Measured at n = 2^20 on an H100 (PERF.md): float32 tiles beat rows at
// d = 65 and 124 and lose at 128 (16-byte rows, where the rows layout loads
// vectors) and 256; bfloat16 tiles win at 65, 124 and 128 and lose at 256.
constexpr int kTilesMaxFeaturesF32 = 124;
constexpr int kTilesMaxFeaturesBf16 = 128;
constexpr int kStageBytes = 65536;   // a stage holds at most this: a tile's X rows and row data
constexpr int kTileMaxRows = 1024;   // rows a tile holds at most
constexpr int kRingBytes = 204800;   // the ring's stages, X and row data together
constexpr int kMaxStages = 4;
constexpr int kAuxBytesPerRow = 12;  // a row's label, offset and weight in a stage

struct TilePlan {
  int rows = 0;        // a tile: whole multiples of 32 (of kThreads past kThreads)
  int stages = 0;      // the ring; the layout needs at least 2
  int partitions = 0;  // threads that own one column each: partitions x d <= kThreads
  int rotation = 0;    // thread t's dot starts at column (t * rotation) mod d
  int stage_bytes = 0;
  int smem = 0;        // dynamic shared memory of a block
};

// Rows per tile: as many as fit a stage of kStageBytes with their label,
// offset and weight, rounded down to a multiple of 32, so every tile starts
// 16-byte aligned whatever d is (32 rows of 2-byte elements are 64 bytes),
// and the ring holds at least three stages. Rotation: a thread reads its
// row at a stride of d elements, so at even d (float32) gcd(d, 32) threads
// of a warp share a bank; starting thread t at column t * rotation makes
// the words the warp reads at one step t * (d + rotation) (float32) or
// t * (d + rotation) / 2 (bfloat16) apart, an odd number of words: 32
// distinct banks, except near the wrap past column d - 1.
inline TilePlan tile_plan(int d, int itemsize) {
  TilePlan p;
  if (d < 1 || d > kThreads) return p;
  const int row_bytes = d * itemsize;
  int rows = kStageBytes / (row_bytes + kAuxBytesPerRow) / 32 * 32;
  if (rows > kTileMaxRows) rows = kTileMaxRows;
  if (rows > kThreads) rows = rows / kThreads * kThreads;
  if (rows < 32) return p;
  p.rows = rows;
  p.stage_bytes = rows * (row_bytes + kAuxBytesPerRow);
  p.stages = kRingBytes / p.stage_bytes < kMaxStages ? kRingBytes / p.stage_bytes : kMaxStages;
  p.partitions = kThreads / d;
  p.rotation = itemsize == 4 ? (d % 2 == 0 ? 1 : 0) : ((2 - d) % 4 + 4) % 4;
  // ring, mbarriers, the block's doubles, its slots, the tile's r, u
  p.smem = p.stages * p.stage_bytes + 8 * p.stages + 8 * kThreads + 8 * (d + 2) + 4 * rows +
           (row_bytes + 15) / 16 * 16;
  return p;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// K1 on narrow rows. A block walks over tiles of R consecutive rows (tile t
// = blockIdx.x + i * gridDim.x for its i-th), each brought into a ring
// stage by bulk copies of its X rows, labels, offsets and weights (all
// contiguous). One thread per row forms the margin from the staged row and
// u in shared memory, evaluates the loss once and leaves r in shared
// memory; then thread t = p * d + j sums column j over the tile's rows p,
// p + P, ... (a warp reads consecutive words: no bank conflicts) in float32
// and adds that to its compensated accumulator. A partial last tile comes
// in by plain loads. part: (gridDim.x, d + 2) float64 as in vg_kernel.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 1)
    vg_tiles_kernel(const T* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ off, const float* __restrict__ wt,
                    const float* __restrict__ u, const float* __restrict__ cp, float cval,
                    long long n, int d, int R, int S, int P, int rotation, int stage_bytes,
                    double* __restrict__ part) {
  using namespace photon_ring;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x;
  const uint32_t bar0 = smem_addr(smem + S * stage_bytes);
  double* red = reinterpret_cast<double*>(smem + S * stage_bytes + 8 * S);
  double* slots = red + kThreads;
  float* rbuf = reinterpret_cast<float*>(slots + d + 2);
  T* us = reinterpret_cast<T*>(rbuf + R);
  const int xbytes = R * d * static_cast<int>(sizeof(T));  // X bytes of a whole tile
  const long long num_tiles = (n + R - 1) / R;
  const long long G = gridDim.x;
  const long long count = blockIdx.x < num_tiles ? (num_tiles - 1 - blockIdx.x) / G + 1 : 0;

  for (int j = tid; j < d; j += kThreads) us[j] = from_float<T>(u[j]);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const uint64_t policy = evict_first_policy();
  // Thread 0 fills stage s with whole tile t; the partial last tile is not
  // issued (the block has no tile after it, so its stage's phase never
  // matters again).
  auto issue = [&](int s, long long t) {
    if ((t + 1) * R > n) return;
    char* st = smem + s * stage_bytes;
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t ab = 4u * R;
    mbar_expect_tx(bar, xbytes + ab * (1 + (off != nullptr) + (wt != nullptr)));
    bulk_load(st, X + t * R * d, xbytes, bar, policy);
    bulk_load(st + xbytes, y + t * R, ab, bar, policy);
    if (off != nullptr) bulk_load(st + xbytes + ab, off + t * R, ab, bar, policy);
    if (wt != nullptr) bulk_load(st + xbytes + 2 * ab, wt + t * R, ab, bar, policy);
  };
  if (tid == 0) {
    for (int i = 0; i < S && i < count; ++i) issue(i, blockIdx.x + i * G);
  }

  const float c = scalar(cp, cval);
  float sums[2] = {0.f, 0.f}, comps[2] = {0.f, 0.f};  // value and r, compensated
  const int owner_p = tid / d;  // this thread's partition; it owns column tid - owner_p * d
  const bool owner = owner_p < P;
  float acc = 0.f, cmp = 0.f;
  const int c0 = (tid * rotation) % d;
  const int split = d - c0;  // the dot's steps before it wraps to column 0

  for (long long i = 0; i < count; ++i) {
    const int s = static_cast<int>(i % S);
    const long long t = blockIdx.x + i * G;
    const int rows = static_cast<int>(n - t * R < R ? n - t * R : R);
    char* st = smem + s * stage_bytes;
    T* xs = reinterpret_cast<T*>(st);
    float* ys = reinterpret_cast<float*>(st + xbytes);
    float* os = ys + R;
    float* ws = os + R;
    if (rows == R) {
      mbar_wait(bar0 + 8 * s, static_cast<uint32_t>((i / S) & 1));
    } else {  // the partial last tile, by plain loads
      const T* xg = X + t * R * d;
      for (int e = tid; e < rows * d; e += kThreads) xs[e] = xg[e];
      for (int q = tid; q < rows; q += kThreads) {
        ys[q] = y[t * R + q];
        if (off != nullptr) os[q] = off[t * R + q];
        if (wt != nullptr) ws[q] = wt[t * R + q];
      }
      __syncthreads();
    }

    // margins and loss, one thread per row: columns c0, ..., d - 1, 0, ...,
    // c0 - 1, each column's index computed from j alone and four partial
    // sums, so no dependence runs from one column to the next but the sum
    for (int q = tid; q < rows; q += kThreads) {
      const T* xr = xs + q * d;
      auto dot_term = [&](int j, float acc) {
        const int col = j < split ? c0 + j : j - split;
        return fmaf(to_float(xr[col]), to_float(us[col]), acc);
      };
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
      int j = 0;
      for (; j + 4 <= d; j += 4) {
        p0 = dot_term(j, p0);
        p1 = dot_term(j + 1, p1);
        p2 = dot_term(j + 2, p2);
        p3 = dot_term(j + 3, p3);
      }
      for (; j < d; ++j) p0 = dot_term(j, p0);
      float m = ((p0 + p1) + (p2 + p3)) - c;
      if (off != nullptr) m += os[q];
      const float yi = ys[q];
      float lv = Loss<L>::value(m, yi);
      float r = Loss<L>::d1(m, yi);
      if (wt != nullptr) {
        const float w = ws[q];
        lv = w != 0.f ? w * lv : 0.f;
        r = w != 0.f ? w * r : 0.f;
      }
      kahan_fma(sums[0], comps[0], lv, 1.f);
      kahan_fma(sums[1], comps[1], r, 1.f);
      rbuf[q] = kBf16 ? round_bf16(r) : r;
    }
    __syncthreads();

    // X^T r: column tid - owner_p * d over rows owner_p, owner_p + P, ...
    // bfloat16 in two partial sums (rows owner_p + 2kP and owner_p +
    // (2k + 1)P), float32 in one: each the faster on the card
    if (owner) {
      const T* xp = xs + tid;  // row owner_p's element of this column
      const int step = P * d;
      int q = owner_p;
      float a0 = 0.f, a1 = 0.f;
      if constexpr (kBf16) {
#pragma unroll 2
        for (; q + P < rows; q += 2 * P, xp += 2 * step) {
          a0 = fmaf(rbuf[q], to_float(xp[0]), a0);
          a1 = fmaf(rbuf[q + P], to_float(xp[step]), a1);
        }
      }
#pragma unroll 4
      for (; q < rows; q += P, xp += step) a0 = fmaf(rbuf[q], to_float(*xp), a0);
      kahan_fma(acc, cmp, a0 + a1, 1.f);
    }
    __syncthreads();  // stage s and r are free again
    if (tid == 0 && i + S < count) issue(s, t + S * G);
  }

  // The block's sums into its float64 slots, in a fixed order: each column
  // over its partitions in order, each scalar by a fixed tree.
  if (owner) red[tid] = static_cast<double>(acc) - cmp;
  __syncthreads();
  for (int j = tid; j < d; j += kThreads) {
    double v = 0.0;
    for (int p = 0; p < P; ++p) v += red[p * d + j];
    slots[j] = v;
  }
  for (int k = 0; k < 2; ++k) {
    __syncthreads();
    red[tid] = static_cast<double>(sums[k]) - comps[k];
    __syncthreads();
    for (int o = kThreads / 2; o > 0; o >>= 1) {
      if (tid < o) red[tid] += red[tid + o];
      __syncthreads();
    }
    if (tid == 0) slots[d + k] = red[0];
  }
  __syncthreads();
  write_block_partial(slots, d + 2, part);
}

// ---------------------------------------------------------------------------
// Launch path: nothing about the device is asked on a call after the first
// ---------------------------------------------------------------------------

// Rows per warp at least this many before another block is added, so small
// problems run on few blocks.
constexpr long long kMinRowsPerWarp = 16;
constexpr long long kMinRowsPerBlock = kWarps * kMinRowsPerWarp;
constexpr int kMaxDevices = 16;

// The SMs of each device, read once.
inline cudaError_t sm_count(int dev, int* sms) {
  static std::atomic<int> cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cache[dev].store(v, std::memory_order_relaxed);
  }
  *sms = v;
  return cudaSuccess;
}

// One kernel instantiation's launch facts per device, each found on first
// need and kept: its dynamic shared memory limit raised to the card's most
// (kernels above 48 KB), and its resident blocks per SM at each width d (a
// kernel's shared memory is a function of d alone). Each Op keeps one in a
// static, so every instantiation has its own.
struct LaunchCache {
  std::atomic<int> raised[kMaxDevices];
  std::atomic<int> per_sm[kMaxDevices][kMaxFeatures + 1];  // resident blocks + 1; 0 not yet asked

  // The blocks that fill the card (as resident blocks allow), at most
  // `need` and `max_grid`.
  template <typename Kernel>
  cudaError_t grid(Kernel kernel, int threads, size_t smem, bool raise, int dev, int d,
                   long long need, int max_grid, int* out) {
    int sms = 0;
    cudaError_t e = sm_count(dev, &sms);
    if (e != cudaSuccess) return e;
    if (raise && raised[dev].load(std::memory_order_relaxed) == 0) {
      // the card's most, less the kernel's static shared memory
      int most = 0;
      cudaFuncAttributes fa;
      e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most - static_cast<int>(fa.sharedSizeBytes));
      if (e != cudaSuccess) return e;
      raised[dev].store(1, std::memory_order_relaxed);
    }
    int per = per_sm[dev][d].load(std::memory_order_relaxed) - 1;
    if (per < 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
      if (e != cudaSuccess) return e;
      per_sm[dev][d].store(per + 1, std::memory_order_relaxed);
    }
    long long g = static_cast<long long>(sms) * (per > 0 ? per : 1);
    if (need < g) g = need;
    if (max_grid < g) g = max_grid;
    *out = static_cast<int>(g < 1 ? 1 : g);
    return cudaSuccess;
  }
};

// A call's arguments. K1: c (cp on the card, else c), part (max_grid, d + 2)
// doubles, out d + 2 floats. K2: also v and cv, part (max_grid, d + 1),
// out d + 1.
struct Args {
  const void* X;
  const float* y;
  const float* off;
  const float* wt;
  const float* u;
  const float* v;
  const float* cp;
  const float* cvp;
  float c;
  float cv;
  long long n;
  int d;
  int dev;
  int max_grid;
  double* part;
  float* out;
  cudaStream_t stream;
};

template <typename T, int L, int VEC, int NV>
struct VgOp {
  static cudaError_t run(const Args& a) {
    static LaunchCache cache;
    auto kernel = vg_kernel<T, L, VEC, NV>;
    const size_t smem = sizeof(double) * (a.d + 2);
    int grid = 0;
    const long long need = (a.n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
    cudaError_t e = cache.grid(kernel, kThreads, smem, false, a.dev, a.d, need, a.max_grid, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(static_cast<const T*>(a.X), a.y, a.off, a.wt, a.u,
                                               a.cp, a.c, a.n, a.d, a.part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    reduce_partials<<<a.d + 2, kReduceThreads, 0, a.stream>>>(a.part, grid, a.d + 2, a.out);
    return cudaGetLastError();
  }
};

template <typename T, int L>
struct VgTilesOp {
  static cudaError_t run(const Args& a) {
    static LaunchCache cache;
    const TilePlan p = tile_plan(a.d, sizeof(T));
    auto kernel = vg_tiles_kernel<T, L>;
    int grid = 0;
    cudaError_t e = cache.grid(kernel, kThreads, p.smem, true, a.dev, a.d,
                               (a.n + p.rows - 1) / p.rows, a.max_grid, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, p.smem, a.stream>>>(static_cast<const T*>(a.X), a.y, a.off, a.wt, a.u,
                                                 a.cp, a.c, a.n, a.d, p.rows, p.stages,
                                                 p.partitions, p.rotation, p.stage_bytes, a.part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    reduce_partials<<<a.d + 2, kReduceThreads, 0, a.stream>>>(a.part, grid, a.d + 2, a.out);
    return cudaGetLastError();
  }
};

template <typename T, int L, int VEC, int NV>
struct HvpOp {
  static cudaError_t run(const Args& a) {
    static LaunchCache cache;
    auto kernel = hvp_kernel<T, L, VEC, NV>;
    const size_t smem = sizeof(double) * (a.d + 1);
    int grid = 0;
    const long long need = (a.n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
    cudaError_t e = cache.grid(kernel, kThreads, smem, false, a.dev, a.d, need, a.max_grid, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(static_cast<const T*>(a.X), a.y, a.off, a.wt, a.u,
                                               a.v, a.cp, a.cvp, a.c, a.cv, a.n, a.d, a.part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    reduce_partials<<<a.d + 1, kReduceThreads, 0, a.stream>>>(a.part, grid, a.d + 1, a.out);
    return cudaGetLastError();
  }
};

// Smallest NV in the instantiated set with d <= 32 * VEC * NV; every set
// reaches kMaxFeatures with at most 32 columns per lane.
template <template <typename, int, int, int> class Op, typename T, int L, int VEC>
cudaError_t by_width(const Args& a) {
  constexpr int kPerNv = 32 * VEC;
  const int d = a.d;
  if constexpr (VEC == 1) {  // scalar loads (unaligned rows): NV in {8, 32}
    if (d <= 8 * kPerNv) return Op<T, L, VEC, 8>::run(a);
    return Op<T, L, VEC, 32>::run(a);
  } else if constexpr (VEC == 8) {  // bfloat16 16-byte vectors: NV in {1, 2, 4}
    if (d <= kPerNv) return Op<T, L, VEC, 1>::run(a);
    if (d <= 2 * kPerNv) return Op<T, L, VEC, 2>::run(a);
    return Op<T, L, VEC, 4>::run(a);
  } else {  // float32 16-byte vectors: NV in {1, 2, 4, 8}
    if (d <= kPerNv) return Op<T, L, VEC, 1>::run(a);
    if (d <= 2 * kPerNv) return Op<T, L, VEC, 2>::run(a);
    if (d <= 4 * kPerNv) return Op<T, L, VEC, 4>::run(a);
    return Op<T, L, VEC, 8>::run(a);
  }
}

// The rows layout: 16-byte vector loads where rows are 16-byte aligned.
template <template <typename, int, int, int> class Op, typename T, int L>
cudaError_t by_layout(const Args& a) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(T));
  const bool wide = a.d % kWide == 0 && reinterpret_cast<std::uintptr_t>(a.X) % 16 == 0;
  if (wide) return by_width<Op, T, L, kWide>(a);
  return by_width<Op, T, L, 1>(a);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// K1's layout: `layout` as asked, or by the rule (kLayoutAuto): the tiles
// layout where its bulk copies can run (X, labels, offsets and weights
// 16-byte aligned, two stages fit) and d is at most the storage type's
// kTilesMaxFeatures*, else the rows layout (vg_kernel).
template <typename T, int L>
cudaError_t vg_launch(int layout, const Args& a) {
  constexpr int kTilesMax =
      std::is_same<T, float>::value ? kTilesMaxFeaturesF32 : kTilesMaxFeaturesBf16;
  const bool tiles_ok = tile_plan(a.d, sizeof(T)).stages >= 2 && aligned16(a.X) && aligned16(a.y) &&
                        (a.off == nullptr || aligned16(a.off)) && (a.wt == nullptr || aligned16(a.wt));
  if (layout == kLayoutAuto) layout = tiles_ok && a.d <= kTilesMax ? kLayoutTiles : kLayoutRows;
  if (layout == kLayoutTiles) {
    if (!tiles_ok) return cudaErrorInvalidValue;
    return VgTilesOp<T, L>::run(a);
  }
  if (layout != kLayoutRows) return cudaErrorInvalidValue;
  return by_layout<VgOp, T, L>(a);
}

// K1 in its layout; K2, which has the rows layout only (hvp_kernel, then
// reduce_partials).
template <typename T, int L, bool kHvp>
cudaError_t by_kernel(int layout, const Args& a) {
  if constexpr (kHvp) {
    return by_layout<HvpOp, T, L>(a);
  } else {
    return vg_launch<T, L>(layout, a);
  }
}

template <typename T, bool kHvp>
cudaError_t by_loss(int loss, int layout, const Args& a) {
  switch (loss) {
    case kLogistic: return by_kernel<T, kLogistic, kHvp>(layout, a);
    case kSquared: return by_kernel<T, kSquared, kHvp>(layout, a);
    case kPoisson: return by_kernel<T, kPoisson, kHvp>(layout, a);
    case kSmoothedHinge: return by_kernel<T, kSmoothedHinge, kHvp>(layout, a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kHvp>
int launch(int x_bf16, int loss, int layout, const Args& a) {
  if (a.d < 1 || a.d > kMaxFeatures) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16) return static_cast<int>(by_loss<__nv_bfloat16, kHvp>(loss, layout, a));
  return static_cast<int>(by_loss<float, kHvp>(loss, layout, a));
}

}  // namespace

extern "C" {

// K1 in a given layout (VgLayout: -1 by the rule, 0 rows, 1 tiles; a layout
// that cannot run on these pointers and shapes is refused). c is read from
// the card at `cp` where it is given, else passed by value. `device` is the
// CUDA ordinal the pointers and the stream belong to. Returns the
// cudaError_t of the launches (0 on success). `part` holds at least
// max_grid * (d + 2) doubles, `out` d + 2 floats: [X^T r | value | r-sum].
int photon_fused_vg_layout(const void* X, int x_bf16, const float* y, const float* off,
                           const float* wt, const float* u, const float* cp, float c, long long n,
                           int d, int loss, int device, int max_grid, double* part, float* out,
                           void* stream, int layout) {
  const Args a{X, y, off, wt, u, nullptr, cp, nullptr, c, 0.f, n, d, device, max_grid, part, out,
               static_cast<cudaStream_t>(stream)};
  return launch<false>(x_bf16, loss, layout, a);
}

// K1 in the layout the rule picks.
int photon_fused_vg(const void* X, int x_bf16, const float* y, const float* off,
                    const float* wt, const float* u, const float* cp, float c, long long n, int d,
                    int loss, int device, int max_grid, double* part, float* out, void* stream) {
  return photon_fused_vg_layout(X, x_bf16, y, off, wt, u, cp, c, n, d, loss, device, max_grid,
                                part, out, stream, kLayoutAuto);
}

// K2. c and cv as K1's c. `part` holds at least max_grid * (d + 1)
// doubles, `out` d + 1 floats: [X^T q | q-sum].
int photon_fused_hvp(const void* X, int x_bf16, const float* y, const float* off,
                     const float* wt, const float* u, const float* v, const float* cp,
                     const float* cvp, float c, float cv, long long n, int d, int loss, int device,
                     int max_grid, double* part, float* out, void* stream) {
  const Args a{X, y, off, wt, u, v, cp, cvp, c, cv, n, d, device, max_grid, part, out,
               static_cast<cudaStream_t>(stream)};
  return launch<true>(x_bf16, loss, kLayoutRows, a);
}

}  // extern "C"
