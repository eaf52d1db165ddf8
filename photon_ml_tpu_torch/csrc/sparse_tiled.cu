// Sparse GLM contraction kernel for Hopper (sm_90a).
//
// K3 `sparse_apply_kernel` replaces the Pallas kernel `_tile_kernel_seg`
// (photon_ml_tpu/ops/sparse_tiled.py, launched there by `_tiled_apply_jit`)
// and its per-group twin `_tile_kernel`, which compute the same function:
// out[i] = sum over write index i's nonzeros of val * src[read] (val^2 with
// `square`). The margins layout has write = row and read = column, the
// gradient layout write = column and read = row; one kernel serves both,
// and the Hessian diagonal's (X o X)^T r with `square`.
//
// Layout (built by ops/sparse_tiled.py): CSR by write index, int64 offsets,
// int32 read indices and values at the rung's storage width, sorted by
// write index and then read index.
//
// Bound on an H100 SXM: bytes. Each nonzero is touched once, with 2 flops
// (4 with the compensation below), so the kernel is bound by its streams --
// the offsets, the indices and the values -- plus the source read once and
// the output written once, over the 3.35 TB/s of device memory: at config
// A2 (2^24 nonzeros, float32 rung) about 0.14 GB, 0.04 ms a direction. The
// source vectors there are 0.5 MB (w) and 2 MB (r), well inside the 50 MB
// L2, so the gathers mostly hit L2.
//
// What the design does about the bound: the streams are read once with
// streaming (evict-first) loads, so they do not push the source out of L2;
// the source is gathered through the read-only cache. One warp owns one
// write index: its lanes stride over the index's nonzeros (lane l takes
// nonzeros l, l + 32, ...), so the stream loads of a warp are contiguous.
// This is the simple first kernel: a write index with many nonzeros (a
// popular feature on the gradient layout) serializes on one warp, and a
// row of few nonzeros leaves lanes idle.
//
// Determinism and accuracy: no atomics. Each lane keeps a compensated
// (Kahan) float32 sum; the lanes' sums are added in float64 by a fixed xor
// butterfly and rounded once to float32, stored by lane 0 with one plain
// store. The result depends on the layout only, so it repeats bitwise. A
// write index with no nonzeros stores 0.
//
// Rungs (storage only; products and sums are float32 on every rung):
//   f32  (0): float32 values.
//   bf16 (1): bfloat16 values; the source is rounded to bfloat16 before the
//             product, as the reference rounds its gathered operand.
//   int8 (2): symmetric int8 values, dequantized by their cell's float32
//             scale, a cell being (write >> 10, read >> 10); the scale table
//             is read through the read-only cache at scale[(write >> 10) *
//             scale_ws + (read >> 10) * scale_rs]. The source is rounded to
//             bfloat16 as on bf16. With `square` the dequantized value is
//             squared; on f32/bf16 the stored value is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlabShift = 10;  // cells of 1024 x 1024 for the int8 scales

// Must agree with `_STORAGE_ID` in ops/sparse_tiled.py.
enum Storage { kF32 = 0, kBf16 = 1, kInt8 = 2 };

template <int S>
struct Stored;

template <>
struct Stored<kF32> {
  using T = float;
  __device__ static float load(const T* p, long long k) { return __ldcs(p + k); }
};

template <>
struct Stored<kBf16> {
  using T = unsigned short;  // bfloat16 bits
  __device__ static float load(const T* p, long long k) {
    return __uint_as_float(static_cast<unsigned int>(__ldcs(p + k)) << 16);  // exact
  }
};

template <>
struct Stored<kInt8> {
  using T = signed char;
  __device__ static float load(const T* p, long long k) {
    return static_cast<float>(__ldcs(p + k));
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Compensated (Kahan) running sum of a * b.
__device__ __forceinline__ void kahan_fma(float& s, float& c, float a, float b) {
  const float y = fmaf(a, b, -c);
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <int S, bool kSquare>
__global__ void __launch_bounds__(kThreads)
    sparse_apply_kernel(const long long* __restrict__ off, const int* __restrict__ rd,
                        const typename Stored<S>::T* __restrict__ vals,
                        const float* __restrict__ scale, long long scale_ws,
                        long long scale_rs, const float* __restrict__ src,
                        long long write_len, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= write_len) return;  // the whole warp leaves together
  const long long begin = off[i];
  const long long end = off[i + 1];
  const float* scale_row = S == kInt8 ? scale + (i >> kSlabShift) * scale_ws : nullptr;

  float s = 0.f, c = 0.f;
  for (long long k = begin + lane; k < end; k += 32) {
    const int r = __ldcs(rd + k);
    float v = Stored<S>::load(vals, k);
    if constexpr (S == kInt8) v *= __ldg(scale_row + static_cast<long long>(r >> kSlabShift) * scale_rs);
    if constexpr (kSquare) v *= v;
    float x = __ldg(src + r);
    if constexpr (S != kF32) x = round_bf16(x);
    kahan_fma(s, c, v, x);
  }
  double t = static_cast<double>(s) - c;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane == 0) out[i] = static_cast<float>(t);
}

template <int S, bool kSquare>
cudaError_t launch(const long long* off, const int* rd, const void* vals, const float* scale,
                   long long scale_ws, long long scale_rs, const float* src,
                   long long write_len, float* out, cudaStream_t stream) {
  const long long blocks = (write_len + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  sparse_apply_kernel<S, kSquare><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      off, rd, static_cast<const typename Stored<S>::T*>(vals), scale, scale_ws, scale_rs, src,
      write_len, out);
  return cudaGetLastError();
}

template <int S>
cudaError_t by_square(int square, const long long* off, const int* rd, const void* vals,
                      const float* scale, long long scale_ws, long long scale_rs,
                      const float* src, long long write_len, float* out, cudaStream_t stream) {
  if (square) return launch<S, true>(off, rd, vals, scale, scale_ws, scale_rs, src, write_len, out, stream);
  return launch<S, false>(off, rd, vals, scale, scale_ws, scale_rs, src, write_len, out, stream);
}

}  // namespace

extern "C" {

// out[i] for i < write_len from the CSR (off, rd, vals); returns the
// cudaError_t of the launch (0 on success). `scale` is read on the int8
// rung only.
int photon_sparse_apply(const long long* off, const int* rd, const void* vals, int storage,
                        const float* scale, long long scale_ws, long long scale_rs,
                        const float* src, long long write_len, int square, float* out,
                        void* stream) {
  if (write_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (write_len == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kF32:
      return static_cast<int>(by_square<kF32>(square, off, rd, vals, scale, scale_ws, scale_rs, src, write_len, out, st));
    case kBf16:
      return static_cast<int>(by_square<kBf16>(square, off, rd, vals, scale, scale_ws, scale_rs, src, write_len, out, st));
    case kInt8:
      if (scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(by_square<kInt8>(square, off, rd, vals, scale, scale_ws, scale_rs, src, write_len, out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
