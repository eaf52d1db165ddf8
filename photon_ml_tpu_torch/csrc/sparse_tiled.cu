// Sparse GLM contraction kernel for Hopper (sm_90a).
//
// K3 replaces the Pallas kernel `_tile_kernel_seg`
// (photon_ml_tpu/ops/sparse_tiled.py, launched there by `_tiled_apply_jit`)
// and its per-group twin `_tile_kernel`, which compute the same function:
// out[i] = sum over write index i's nonzeros of val * src[read] (val^2 with
// `square`). The margins layout has write = row and read = column, the
// gradient layout write = column and read = row; one kernel serves both,
// and the Hessian diagonal's (X o X)^T r with `square`.
//
// Layout (built by ops/sparse_tiled.py): CSR by write index, int64 offsets,
// int32 read indices and values at the rung's storage width, sorted by
// write index and then read index. The nonzeros are cut into tiles of
// kTileNnz; `tile_write[t]` is the first write index whose nonzeros begin
// at or after tile t's first position (torch.searchsorted over the
// offsets), and `tile_write[num_tiles]` the first write index past the last
// nonzero. Streams are padded in storage so that every copy below stays in
// bounds and is whole 16-byte units: read indices and values to a whole
// number of tiles (the pad is masked out, never summed), offsets to two
// entries past write_len, rounded to an even count, and each int8 scale
// row to a multiple of four floats.
//
// Bound on an H100 SXM. By bytes: each nonzero is touched once, with 2
// flops, so the least time is that of the streams -- the offsets, the
// indices and the values -- plus the source read once and the output
// written once, over the 3.35 TB/s of device memory: at config A2 (2^24
// nonzeros, float32 rung) about 0.14 GB, 0.042 ms a direction. But each
// nonzero also gathers src[read] at a random index: the source (0.5 MB w,
// 2 MB r at A2) stays in the 50 MB L2, yet every gather that misses L1 is
// one L2 request of a 32-byte sector, and the card serves 2^24 of those in
// about 0.12 ms (chip_smoke.py's `gather_floor` phase). That, not the
// bytes, sets this layout's time.
//
// What the design does:
// - Work is cut by nonzeros, not by write index: a block takes whole tiles
//   of kTileNnz nonzeros (grid-stride over the tiles), and each of its
//   threads walks a fixed run of kItems nonzeros. Short rows pack many to a
//   tile, so no lane idles, and a long write list (a popular column of the
//   gradient layout) spreads over many blocks.
// - The streams do not wait on the offsets: a tile's read indices and
//   values are one contiguous range each, copied into shared memory by
//   one-dimensional TMA bulk copies (`cp.async.bulk`, first to evict from
//   L2, so they do not push the source out) that complete on an mbarrier,
//   together with the tile's slice of the offsets and (int8) its scale
//   rows. The ring has kStages stages: thread 0 issues the copies of the
//   block's tile kStages - 1 ahead before the block waits for this tile's,
//   so the next streams are in flight while this tile's gathers and sums
//   run. A tile whose offsets slice or scale rows exceed their stage buffer
//   (many empty write indices, or a wide scale row) reads those from
//   global memory instead.
// - The gathers: each thread issues all kItems of its gathers before it
//   uses any of them. Small blocks and few of them per SM keep the shared
//   memory small, since it comes out of the L1 that caches the gathered
//   source (see kBlocksPerSm). The reduced rungs gather a bfloat16 copy of
//   the source, which the wrapper rounds: the same operand the products
//   take, in half the bytes, so twice as much of it fits L1.
//
// Sums, with no atomics and a fixed order: each thread finds the write
// index of its first nonzero by a binary search in the offsets slice, then
// walks its run, summing float32 products in float64 per write index. A
// write index that starts and ends inside one thread's run is stored by
// that thread; the pieces that cross thread boundaries are joined by a
// block-wide segmented scan (warp shuffles, then the warps' totals in
// order). A write index wholly inside the tile is stored once, by the
// thread that holds its last nonzero. A write index that crosses a tile
// boundary leaves one float64 piece per tile in the `carry` scratch
// (2 per tile: [2t] the piece of a write index that began before tile t,
// [2t + 1] the piece of one that begins in tile t and runs past it), and a
// second kernel in the same call adds those pieces in tile order and
// stores the sum. Empty write indices store 0: the thread whose run
// starts at their position stores them, and the second kernel stores those
// past the last nonzero. Every float64 sum is rounded once to float32, as
// the plain version rounds its float64 sum; the result depends on the
// layout only, so it repeats bitwise.
//
// Rungs (storage only; products are float32 on every rung):
//   f32  (0): float32 values.
//   bf16 (1): bfloat16 values; the source is rounded to bfloat16 before the
//             product (by the wrapper), as the reference rounds its
//             gathered operand.
//   int8 (2): symmetric int8 values, dequantized by their cell's float32
//             scale, a cell being (write >> 10, read >> 10); the layout's
//             scale table is write-major, scale[(write >> 10) * scale_ld +
//             (read >> 10)]. The source is rounded to bfloat16 as on bf16.
//             With `square` the dequantized value is squared; on f32/bf16
//             the stored value is.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "ring.cuh"

namespace {

using photon_ring::bulk_load;
using photon_ring::evict_first_policy;
using photon_ring::mbar_expect_tx;
using photon_ring::mbar_fence_init;
using photon_ring::mbar_init;
using photon_ring::mbar_wait;
using photon_ring::smem_addr;

constexpr int kThreads = 64;  // a block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // nonzeros a thread walks in a tile
constexpr int kTileNnz = 512;
static_assert(kTileNnz == kThreads * kItems, "a tile is one run per thread");
constexpr int kSlabShift = 10;  // cells of 1024 x 1024 for the int8 scales
constexpr int kOffCap = 64;     // offsets a stage holds
constexpr int kScaleCap = 1024;  // int8 scale floats a stage holds
// Blocks a streaming multiprocessor runs at once. Each holds its stages in
// shared memory, which the SM takes from its L1. A source of at most
// kSmallSource bytes runs kBlocksSmallSource blocks, whose shared memory
// (f32 and bf16) fits the 64 KB carveout and leaves 192 KB of L1 to cache a
// third or more of the source; a larger one gains little from L1 and runs
// kBlocksPerSm blocks, for more warps to cover the gathers' latency. Chosen
// on the card at A2 (PERF.md).
constexpr int kBlocksPerSm = 8;
constexpr int kBlocksSmallSource = 6;
constexpr long long kSmallSource = 512 << 10;
constexpr int kStages = 2;  // the ring of tiles in flight per block

// Must agree with `_STORAGE_ID` in ops/sparse_tiled.py.
enum Storage { kF32 = 0, kBf16 = 1, kInt8 = 2 };

template <int S>
struct Stored;

__device__ __forceinline__ float bf16_bits(unsigned short v) {
  return __uint_as_float(static_cast<unsigned int>(v) << 16);  // exact
}

// T: a stored value; Src: an element of the source the kernel gathers
// (bfloat16 bits on the reduced rungs, already rounded by the wrapper).
template <>
struct Stored<kF32> {
  using T = float;
  using Src = float;
  __device__ static float decode(T v) { return v; }
  __device__ static float gather(const Src* p) { return __ldg(p); }
};

template <>
struct Stored<kBf16> {
  using T = unsigned short;  // bfloat16 bits
  using Src = unsigned short;
  __device__ static float decode(T v) { return bf16_bits(v); }
  __device__ static float gather(const Src* p) { return bf16_bits(__ldg(p)); }
};

template <>
struct Stored<kInt8> {
  using T = signed char;
  using Src = unsigned short;
  __device__ static float decode(T v) { return static_cast<float>(v); }
  __device__ static float gather(const Src* p) { return bf16_bits(__ldg(p)); }
};

// Byte offsets of the buffers of one ring stage; every one is a multiple
// of 16, as the bulk copies need.
template <int S>
struct Stage {
  static constexpr int kRead = 0;
  static constexpr int kVals = kRead + kTileNnz * 4;
  static constexpr int kOff = kVals + kTileNnz * static_cast<int>(sizeof(typename Stored<S>::T));
  static constexpr int kScale = kOff + kOffCap * 8;
  static constexpr int kBytes = kScale + (S == kInt8 ? kScaleCap * 4 : 0);
};

// The ring's stages and mbarriers, and the scan's per-warp totals and flags.
template <int S>
constexpr int smem_bytes() {
  return kStages * (Stage<S>::kBytes + 8) + kWarps * 8 + kWarps * 4;
}

// The write indices a tile may touch: its offsets slice covers [wf, wn].
struct TileMeta {
  long long wf, wn;
};

__device__ __forceinline__ TileMeta tile_meta(const long long* tile_write, long long t,
                                              long long num_tiles) {
  if (t >= num_tiles) return {0, 0};
  const long long first = __ldg(tile_write + t);
  // the write index holding the tile's first nonzero lies before `first`
  // when that one began in an earlier tile
  return {first > 0 ? first - 1 : 0, __ldg(tile_write + t + 1)};
}

// Where a tile's offsets and scale rows come from: a stage buffer when
// they fit, else global memory.
struct Plan {
  long long off_lo;  // first offset in the stage buffer (even, so 16-byte aligned)
  int off_cnt;       // offsets copied (even); 0 when read from global memory
  long long sc_row;  // first scale row in the stage buffer
  int sc_floats;     // scale floats copied; 0 when read from global memory
};

template <int S>
__device__ __forceinline__ Plan plan(TileMeta m, long long write_len, long long scale_ld) {
  Plan p;
  p.off_lo = m.wf & ~1LL;
  const long long cnt = (m.wn + 2 - p.off_lo) & ~1LL;  // [off_lo, wn] rounded up to even
  p.off_cnt = cnt <= kOffCap ? static_cast<int>(cnt) : 0;
  p.sc_row = m.wf >> kSlabShift;
  p.sc_floats = 0;
  if constexpr (S == kInt8) {
    const long long last = min(m.wn >> kSlabShift, ((write_len + 1023) >> kSlabShift) - 1);
    const long long floats = (last - p.sc_row + 1) * scale_ld;
    if (floats <= kScaleCap) p.sc_floats = static_cast<int>(floats);
  }
  return p;
}

template <int S>
__device__ __forceinline__ void issue(char* stage, uint32_t bar, long long t, const Plan& p,
                                      const int* rd, const typename Stored<S>::T* vals,
                                      const long long* off, const float* scale,
                                      long long scale_ld) {
  using T = typename Stored<S>::T;
  const long long k = t * kTileNnz;
  const uint32_t bytes = kTileNnz * 4 + kTileNnz * sizeof(T) + p.off_cnt * 8 + p.sc_floats * 4;
  const uint64_t policy = evict_first_policy();
  mbar_expect_tx(bar, bytes);
  bulk_load(stage + Stage<S>::kRead, rd + k, kTileNnz * 4, bar, policy);
  bulk_load(stage + Stage<S>::kVals, vals + k, kTileNnz * sizeof(T), bar, policy);
  if (p.off_cnt) bulk_load(stage + Stage<S>::kOff, off + p.off_lo, p.off_cnt * 8, bar, policy);
  if (p.sc_floats)
    bulk_load(stage + Stage<S>::kScale, scale + p.sc_row * scale_ld, p.sc_floats * 4, bar, policy);
}

// kItems consecutive elements from shared memory, 16 or 8 bytes a load,
// split into elements by shifts.
template <typename T>
__device__ __forceinline__ void load_items(const T* base, T (&dst)[kItems]) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // elements in a 32-bit word
  constexpr int kWords = kItems / kPer;
  uint32_t w[kWords];
  if constexpr (kWords == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(base);
    w[0] = u.x, w[1] = u.y;
  } else {
    static_assert(kWords % 4 == 0, "16-byte loads");
#pragma unroll
    for (int q = 0; q < kWords / 4; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(base)[q];
      w[4 * q] = u.x, w[4 * q + 1] = u.y, w[4 * q + 2] = u.z, w[4 * q + 3] = u.w;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t bits = w[j / kPer] >> (8 * sizeof(T) * (j % kPer));
    if constexpr (std::is_same_v<T, float>) {
      dst[j] = __uint_as_float(bits);
    } else if constexpr (sizeof(T) == 4) {
      dst[j] = static_cast<T>(bits);
    } else if constexpr (sizeof(T) == 2) {
      dst[j] = static_cast<T>(bits & 0xffffu);
    } else {
      dst[j] = static_cast<T>(static_cast<signed char>(bits & 0xffu));
    }
  }
}

// Block-wide inclusive and exclusive segmented sums: a set flag starts a
// new segment at that thread. Fixed order, so the result repeats bitwise.
__device__ __forceinline__ void block_scan(int flag, double val, double* warp_val, int* warp_flag,
                                           double& incl, double& excl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double pv = __shfl_up_sync(0xffffffffu, val, o);
    const int pf = __shfl_up_sync(0xffffffffu, flag, o);
    if (lane >= o) {
      if (!flag) val = pv + val;
      flag |= pf;
    }
  }
  if (lane == 31) warp_val[warp] = val, warp_flag[warp] = flag;
  __syncthreads();
  double pre = 0.0;
  for (int q = 0; q < warp; ++q) pre = warp_flag[q] ? warp_val[q] : pre + warp_val[q];
  incl = flag ? val : pre + val;
  excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = pre;
}

template <int S, bool kSquare>
__device__ __forceinline__ void tile_body(const char* stage, long long t, TileMeta m, const Plan& p,
                                          const long long* off, const float* scale,
                                          long long scale_ld,
                                          const typename Stored<S>::Src* src, long long nnz,
                                          double* carry, float* out, double* warp_val,
                                          int* warp_flag) {
  using T = typename Stored<S>::T;
  const int tid = threadIdx.x;
  const long long s0 = t * kTileNnz;
  const long long e = min(s0 + kTileNnz, nnz);
  const long long k0 = s0 + static_cast<long long>(tid) * kItems;
  const long long k1 = min(k0 + kItems, e);
  const bool active = k0 < e;
  // one generic pointer each, so every lookup is one load from wherever
  // the plan put the offsets and scale rows
  const long long* ob = p.off_cnt ? reinterpret_cast<const long long*>(stage + Stage<S>::kOff) : off;
  const long long obase = p.off_cnt ? p.off_lo : 0;
  const float* sb = p.sc_floats ? reinterpret_cast<const float*>(stage + Stage<S>::kScale)
                                : scale + p.sc_row * scale_ld;

  int flag = 0;      // the scan's segment start: this run begins its last write index
  double val = 0.0;  // the scan's value: this run's piece of its last write index
  long long w_first = 0, w = 0, first_start = 0, start = 0;
  bool head_open = false, head_done = false, tail_open = false;
  double head = 0.0;
  if (active) {
    int r[kItems];
    T raw[kItems];
    load_items(reinterpret_cast<const int*>(stage + Stage<S>::kRead) + tid * kItems, r);
    load_items(reinterpret_cast<const T*>(stage + Stage<S>::kVals) + tid * kItems, raw);
    float x[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) x[j] = Stored<S>::gather(src + r[j]);  // the pad holds index 0

    // the write index of nonzero k0: the last w in [wf, wn] with off[w] <= k0
    long long lo = m.wf - obase, hi = m.wn - obase;
    while (lo < hi) {
      const long long mid = lo + ((hi - lo + 1) >> 1);
      if (ob[mid] <= k0) lo = mid; else hi = mid - 1;
    }
    w_first = lo + obase;
    first_start = ob[lo];
    head_open = first_start < k0;
    if (!head_open) {  // empty write indices at position k0 are this thread's
      for (long long q = lo - 1; q >= m.wf - obase && ob[q] == k0; --q) out[q + obase] = 0.f;
    }

    auto finish = [&](long long wi, double acc) {
      if (wi == w_first && head_open) {
        head = acc, head_done = true;  // joined with earlier threads' pieces below
      } else {
        out[wi] = static_cast<float>(acc);  // begins and ends in this run
      }
    };
    w = w_first;
    start = first_start;
    long long end = ob[w + 1 - obase];
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long k = k0 + j;
      if (k < k1) {
        while (end <= k) {
          finish(w, acc);
          acc = 0.0;
          start = end;
          end = ob[++w + 1 - obase];
        }
        float v = Stored<S>::decode(raw[j]);
        if constexpr (S == kInt8)
          v = __fmul_rn(v, sb[((w >> kSlabShift) - p.sc_row) * scale_ld + (r[j] >> kSlabShift)]);
        if constexpr (kSquare) v = __fmul_rn(v, v);
        acc += static_cast<double>(__fmul_rn(v, x[j]));
      }
    }
    if (end == k1) {
      finish(w, acc);
      flag = 1;
    } else {
      tail_open = true;
      val = acc;
      flag = !(w == w_first && head_open);
    }
  }

  double incl, excl;
  block_scan(flag, val, warp_val, warp_flag, incl, excl);
  if (!active) return;
  if (head_done) {
    const double total = excl + head;
    if (first_start >= s0) out[w_first] = static_cast<float>(total);  // wholly in this tile
    else carry[2 * t] = total;
  }
  if (tail_open && k1 == e) {  // the tile's last write index runs past it
    if (start >= s0) carry[2 * t + 1] = incl;
    else carry[2 * t] = incl;
  }
}

template <int S, bool kSquare>
__global__ void __launch_bounds__(kThreads)
    sparse_tile_kernel(const long long* __restrict__ off, const int* __restrict__ rd,
                       const typename Stored<S>::T* __restrict__ vals,
                       const float* __restrict__ scale, long long scale_ld,
                       const typename Stored<S>::Src* __restrict__ src, long long write_len,
                       long long nnz,
                       const long long* __restrict__ tile_write, long long num_tiles,
                       double* __restrict__ carry, float* __restrict__ out) {
  extern __shared__ __align__(128) char smem[];
  constexpr int kStage = Stage<S>::kBytes;
  const uint32_t bar0 = smem_addr(smem + kStages * kStage);
  double* warp_val = reinterpret_cast<double*>(smem + kStages * kStage + 8 * kStages);
  int* warp_flag = reinterpret_cast<int*>(warp_val + kWarps);
  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) mbar_init(bar0 + 8 * q, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // The block's tiles are t0, t0 + grid, ...; its i-th goes to stage
  // i % kStages. Tile metadata is loaded one tile ahead of its use: `cur`
  // and `nxt` for the sums, `ahead` for thread 0's copies.
  const long long grid = gridDim.x;
  long long t = blockIdx.x;
  TileMeta cur = tile_meta(tile_write, t, num_tiles);
  TileMeta nxt = tile_meta(tile_write, t + grid, num_tiles);
  TileMeta ahead = nxt;
  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages - 1; ++q) {
      const long long tq = t + q * grid;
      if (tq < num_tiles)
        issue<S>(smem + q * kStage, bar0 + 8 * q, tq,
                 plan<S>(q == 0 ? cur : tile_meta(tile_write, tq, num_tiles), write_len, scale_ld),
                 rd, vals, off, scale, scale_ld);
    }
    ahead = tile_meta(tile_write, t + (kStages - 1) * grid, num_tiles);
  }
  for (int i = 0; t < num_tiles; ++i, t += grid) {
    const int s = i % kStages;
    const TileMeta after = tile_meta(tile_write, t + 2 * grid, num_tiles);
    // the stage before this one was released by the __syncthreads that
    // ended the last tile
    const long long tn = t + (kStages - 1) * grid;
    if (threadIdx.x == 0) {
      const int sn = (i + kStages - 1) % kStages;
      if (tn < num_tiles)
        issue<S>(smem + sn * kStage, bar0 + 8 * sn, tn, plan<S>(ahead, write_len, scale_ld), rd,
                 vals, off, scale, scale_ld);
      ahead = tile_meta(tile_write, tn + grid, num_tiles);
    }
    mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
    tile_body<S, kSquare>(smem + s * kStage, t, cur, plan<S>(cur, write_len, scale_ld), off,
                          scale, scale_ld, src, nnz, carry, out, warp_val, warp_flag);
    __syncthreads();
    cur = nxt;
    nxt = after;
  }
}

// The write indices that cross tile boundaries, each summed from its
// per-tile pieces in tile order, and the empty write indices past the last
// nonzero. One thread per tile boundary b: the write index holding
// position b * kTileNnz adds its pieces there if it began in tile b - 1.
__global__ void __launch_bounds__(256)
    carry_kernel(const long long* __restrict__ off, const long long* __restrict__ tile_write,
                 long long num_tiles, long long write_len, const double* __restrict__ carry,
                 float* __restrict__ out) {
  const long long w_end = tile_write[num_tiles];
  const long long bounds = num_tiles > 0 ? num_tiles - 1 : 0;
  const long long total = bounds + (write_len - w_end);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    if (i >= bounds) {
      out[w_end + (i - bounds)] = 0.f;
      continue;
    }
    const long long b = i + 1, pos = b * kTileNnz;
    const long long first = tile_write[b];
    if (off[first] == pos) continue;  // no write index crosses pos
    const long long w = first - 1;
    if (off[w] < pos - kTileNnz) continue;  // an earlier boundary's thread adds it
    double s = carry[2 * (b - 1) + 1];
    const long long end = off[w + 1];
    for (long long j = b;; ++j) {
      s += carry[2 * j];
      if (end <= (j + 1) * kTileNnz) break;
    }
    out[w] = static_cast<float>(s);
  }
}

template <int S, bool kSquare>
cudaError_t launch(const long long* off, const int* rd, const void* vals, const float* scale,
                   long long scale_ld, const void* src, long long read_len, long long write_len,
                   long long nnz,
                   const long long* tile_write, double* carry, float* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long num_tiles = (nnz + kTileNnz - 1) / kTileNnz;
  if (num_tiles > 0) {
    auto kernel = sparse_tile_kernel<S, kSquare>;
    constexpr int smem = smem_bytes<S>();
    const long long src_bytes = read_len * static_cast<long long>(sizeof(typename Stored<S>::Src));
    const int bps = src_bytes <= kSmallSource ? kBlocksSmallSource : kBlocksPerSm;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // shared memory for bps blocks (1 KB each reserved), the rest L1
    const int carveout = ((smem + 1024) * bps * 100 + 233471) / 233472;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 carveout < 100 ? carveout : 100);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    const long long blocks =
        std::min(num_tiles, static_cast<long long>(std::clamp(per_sm, 1, bps)) * sms);
    kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
        off, rd, static_cast<const typename Stored<S>::T*>(vals), scale, scale_ld,
        static_cast<const typename Stored<S>::Src*>(src), write_len,
        nnz, tile_write, num_tiles, carry, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long work = num_tiles + write_len;
  const long long blocks = std::min((work + 255) / 256, static_cast<long long>(sms));
  carry_kernel<<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(off, tile_write, num_tiles,
                                                                      write_len, carry, out);
  return cudaGetLastError();
}

template <int S>
cudaError_t by_square(int square, const long long* off, const int* rd, const void* vals,
                      const float* scale, long long scale_ld, const void* src, long long read_len,
                      long long write_len,
                      long long nnz, const long long* tile_write, double* carry, float* out,
                      cudaStream_t stream) {
  if (square)
    return launch<S, true>(off, rd, vals, scale, scale_ld, src, read_len, write_len, nnz, tile_write, carry,
                           out, stream);
  return launch<S, false>(off, rd, vals, scale, scale_ld, src, read_len, write_len, nnz, tile_write, carry,
                          out, stream);
}

}  // namespace

extern "C" {

// out[i] for i < write_len from the tiled CSR (off, rd, vals, tile_write);
// `carry` is scratch of 2 * ceil(nnz / kTileNnz) doubles. Returns the
// cudaError_t of the launches (0 on success). `scale` is read on the int8
// rung only.
int photon_sparse_apply(const long long* off, const int* rd, const void* vals, int storage,
                        const float* scale, long long scale_ld, const void* src,
                        long long read_len, long long write_len, long long nnz, const long long* tile_write,
                        double* carry, int square, float* out, void* stream) {
  if (write_len < 0 || nnz < 0 || read_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (write_len == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kF32:
      return static_cast<int>(by_square<kF32>(square, off, rd, vals, scale, scale_ld, src,
                                              read_len, write_len, nnz, tile_write, carry, out, st));
    case kBf16:
      return static_cast<int>(by_square<kBf16>(square, off, rd, vals, scale, scale_ld, src,
                                               read_len, write_len, nnz, tile_write, carry, out, st));
    case kInt8:
      if (scale == nullptr || scale_ld % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(by_square<kInt8>(square, off, rd, vals, scale, scale_ld, src,
                                               read_len, write_len, nnz, tile_write, carry, out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
