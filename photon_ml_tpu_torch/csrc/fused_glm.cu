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
// 0.32 ms for X of 1 GiB (n = 2^20, d = 512 in bf16, or d = 256 in f32).
// The arithmetic (4 n d flops for K1, 6 n d for K2, plus 3 n d for the
// compensated sums below, in float32 on the CUDA cores at 67 TFLOP/s) stays
// under a fifth of that time.
//
// What the design does about the bound: X is read exactly once per
// evaluation, with streaming (evict-first) loads, and nothing per row goes
// back to device memory. A warp owns one row at a time: its lanes load the
// row in 16-byte vectors where the row is 16-byte aligned (lane l holds
// vectors l, l + 32, ...; scalars otherwise), form the margin dot (and, in
// K2, the dot with v from the same registers), reduce it with a butterfly
// so every lane holds the same bits, apply the loss in registers, and add
// r * x (or q * x) into per-lane column accumulators. Where a lane holds at
// most 16 columns, each warp loads two rows before it reduces either, to
// keep more bytes in flight. Neither the margins nor r / q are ever stored.
//
// Determinism and accuracy: no float atomics. Each warp keeps compensated
// (Kahan) float32 sums over its rows; the warps of a block add theirs in
// warp order into float64 slots, each block writes its own row of a
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
// Masking: rows >= n are never loaded; where weights are given, a zero
// weight makes the row contribute exactly 0 through a select, so a Poisson
// exp overflow on a padded row cannot become NaN. A null `off` / `wt`
// pointer means offsets 0 / weights 1 and the array is not read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
              const float* __restrict__ u, const float* __restrict__ sc,
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
  const float c = sc[0];
  float sums[2] = {0.f, 0.f}, comps[2] = {0.f, 0.f};

  for_each_row<T, VEC, NV>(X, n, d, lane, warp, [&](const float (&x)[E], long long i) {
    vg_row<L, kBf16, E>(x, ur, i, c, y, off, wt, acc, cmp, sums, comps);
  });

  add_warp_sums<VEC, NV, 2>(slots, d, lane, warp, acc, cmp, sums, comps);
  write_block_partial(slots, d + 2, part);
}

// K2. part: (gridDim.x, d + 1) float64 = [X^T q | sum q] per block; sc = [c, cv].
template <typename T, int L, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
    hvp_kernel(const T* __restrict__ X, const float* __restrict__ y,
               const float* __restrict__ off, const float* __restrict__ wt,
               const float* __restrict__ u, const float* __restrict__ v,
               const float* __restrict__ sc, long long n, int d,
               double* __restrict__ part) {
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
  const float c = sc[0];
  const float cv = sc[1];
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

// Rows per warp at least this many before another block is added, so small
// problems run on few blocks.
constexpr long long kMinRowsPerWarp = 16;

template <typename Kernel>
cudaError_t grid_for(Kernel kernel, size_t smem, long long n, int max_grid, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  long long g = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (n + kWarps * kMinRowsPerWarp - 1) / (kWarps * kMinRowsPerWarp);
  if (need < g) g = need;
  if (max_grid < g) g = max_grid;
  *grid = static_cast<int>(g < 1 ? 1 : g);
  return cudaSuccess;
}

template <typename T, int L, int VEC, int NV>
struct VgOp {
  static cudaError_t run(const void* X, const float* y, const float* off, const float* wt,
                         const float* u, const float* sc, long long n, int d, int max_grid,
                         double* part, float* out, cudaStream_t stream) {
    auto kernel = vg_kernel<T, L, VEC, NV>;
    const size_t smem = sizeof(double) * (d + 2);
    int grid = 0;
    cudaError_t e = grid_for(kernel, smem, n, max_grid, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(X), y, off, wt, u, sc, n, d, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    reduce_partials<<<d + 2, kReduceThreads, 0, stream>>>(part, grid, d + 2, out);
    return cudaGetLastError();
  }
};

template <typename T, int L, int VEC, int NV>
struct HvpOp {
  static cudaError_t run(const void* X, const float* y, const float* off, const float* wt,
                         const float* u, const float* v, const float* sc, long long n, int d,
                         int max_grid, double* part, float* out, cudaStream_t stream) {
    auto kernel = hvp_kernel<T, L, VEC, NV>;
    const size_t smem = sizeof(double) * (d + 1);
    int grid = 0;
    cudaError_t e = grid_for(kernel, smem, n, max_grid, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(X), y, off, wt, u, v, sc, n, d,
                                             part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    reduce_partials<<<d + 1, kReduceThreads, 0, stream>>>(part, grid, d + 1, out);
    return cudaGetLastError();
  }
};

// Smallest NV in the instantiated set with d <= 32 * VEC * NV; every set
// reaches kMaxFeatures with at most 32 columns per lane.
template <template <typename, int, int, int> class Op, typename T, int L, int VEC, typename... A>
cudaError_t by_width(int d, A... args) {
  constexpr int kPerNv = 32 * VEC;
  if constexpr (VEC == 1) {  // scalar loads (unaligned rows): NV in {8, 32}
    if (d <= 8 * kPerNv) return Op<T, L, VEC, 8>::run(args...);
    return Op<T, L, VEC, 32>::run(args...);
  } else if constexpr (VEC == 8) {  // bfloat16 16-byte vectors: NV in {1, 2, 4}
    if (d <= kPerNv) return Op<T, L, VEC, 1>::run(args...);
    if (d <= 2 * kPerNv) return Op<T, L, VEC, 2>::run(args...);
    return Op<T, L, VEC, 4>::run(args...);
  } else {  // float32 16-byte vectors: NV in {1, 2, 4, 8}
    if (d <= kPerNv) return Op<T, L, VEC, 1>::run(args...);
    if (d <= 2 * kPerNv) return Op<T, L, VEC, 2>::run(args...);
    if (d <= 4 * kPerNv) return Op<T, L, VEC, 4>::run(args...);
    return Op<T, L, VEC, 8>::run(args...);
  }
}

template <template <typename, int, int, int> class Op, typename T, int L, typename... A>
cudaError_t by_layout(const void* X, int d, A... args) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(T));
  const bool wide = d % kWide == 0 && reinterpret_cast<std::uintptr_t>(X) % 16 == 0;
  if (wide) return by_width<Op, T, L, kWide>(d, args...);
  return by_width<Op, T, L, 1>(d, args...);
}

template <template <typename, int, int, int> class Op, typename T, typename... A>
cudaError_t by_loss(int loss, const void* X, int d, A... args) {
  switch (loss) {
    case kLogistic: return by_layout<Op, T, kLogistic>(X, d, args...);
    case kSquared: return by_layout<Op, T, kSquared>(X, d, args...);
    case kPoisson: return by_layout<Op, T, kPoisson>(X, d, args...);
    case kSmoothedHinge: return by_layout<Op, T, kSmoothedHinge>(X, d, args...);
    default: return cudaErrorInvalidValue;
  }
}

// Template dispatch over (storage type, loss id, load width, columns per lane).
template <template <typename, int, int, int> class Op, typename... A>
cudaError_t dispatch(int x_bf16, int loss, const void* X, int d, A... args) {
  if (d < 1 || d > kMaxFeatures) return cudaErrorInvalidValue;
  if (x_bf16) return by_loss<Op, __nv_bfloat16>(loss, X, d, X, args...);
  return by_loss<Op, float>(loss, X, d, X, args...);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 on success). `part` holds at
// least max_grid * (d + 2) floats, `out` d + 2: [X^T r | value | r-sum].
int photon_fused_vg(const void* X, int x_bf16, const float* y, const float* off,
                    const float* wt, const float* u, const float* sc, long long n, int d,
                    int loss, int max_grid, double* part, float* out, void* stream) {
  return static_cast<int>(dispatch<VgOp>(x_bf16, loss, X, d, y, off, wt, u, sc, n, d, max_grid,
                                         part, out, static_cast<cudaStream_t>(stream)));
}

// `part` holds at least max_grid * (d + 1) floats, `out` d + 1: [X^T q | q-sum].
int photon_fused_hvp(const void* X, int x_bf16, const float* y, const float* off,
                     const float* wt, const float* u, const float* v, const float* sc,
                     long long n, int d, int loss, int max_grid, double* part, float* out,
                     void* stream) {
  return static_cast<int>(dispatch<HvpOp>(x_bf16, loss, X, d, y, off, wt, u, v, sc, n, d,
                                          max_grid, part, out, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
