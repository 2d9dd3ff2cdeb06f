// K4 sweep_fwd and K4b sweep_bwd: the full multiresolution hash encode of
// the "ref" table layout for small tables (2^log2_hashmap_size <= 2^14),
// linear interpolation, and its table gradient.  Forward: x01 [N, 3] ->
// features [N, L*3], zero for points outside [0, 1]^3.  Backward: the
// output gradient g [N, L*3] -> dtable [total, 3], the sum over (point,
// level, corner) of w * g[p, l, :] at the corner's row (w the trilinear
// weight, zero out of bounds).
//
// Replaces: K4, nerf2mesh_tpu/ops/pallas_encode.py `_kernel` (via
// _fwd_pallas / sweep_encode).  On the TPU the whole table sits in VMEM as a
// padded channel-major [L*C, S] copy and each 128-point tile sweeps every
// 1024-entry block of it with lane gathers, because XLA's random gathers
// were scalar loops there.  K4b has no TPU kernel: JAX's `_sweep_bwd`
// (pallas_encode.py:212) is an XLA scatter, whose docstring names an
// in-kernel backward as the planned follow-up.
//
// Indices (those of hashgrid._corner_indices for the ref layout): a dense
// level reads row ix + iy*side + iz*side^2 (side = resolution + 1; side^3
// never exceeds the level's size on a hash grid, so the modulo by the size
// is taken only on a tiled grid, where it can); a hashed level reads
// (ix*1 ^ iy*2654435761 ^ iz*805459861) & (size - 1) in uint32, which wraps
// for free.  The lattice position x*scale + shift is computed with
// __fmul_rn/__fadd_rn so its floor equals PyTorch's separately rounded
// multiply and add (hashgrid.lattice): the forward, the backward and the
// plain versions pick the same rows.
//
// Bound on the H100: bytes.  Per (point, level) the forward reads 12 B of
// position and writes 12 B (50 MB at 2^18 points and 16 levels); the
// backward reads 12 B of gradient and writes the 2.98 MB table gradient
// once.  The table itself (2.84 MiB at the slice's spec) is small.
//
// Design: the JAX kernel's idea, a table in fast memory, per level.  A
// thread block takes one level of a chunk of points and copies the level's
// slice (size_l * 12 B: 58 KiB at level 0, 192 KiB at a hashed level of
// 2^14 rows) into dynamic shared memory once, with 16-byte cp.async copies;
// every corner read is then a shared load, where the first port made 8
// random 12-byte L2 reads per (point, level), ~42M sectors at 2^18 points.
// One block an SM (1024 threads).  The per-level constants come by value
// in the launch (SweepParams, 64 levels a launch; more take more launches),
// not from a device array read by every thread.  The chunk count comes from
// the caller (pallas_encode.sweep_chunks): one wave on a large input, fewer
// chunks on a small one.
//
// K4's output is point-major [N, L*3]: a block that owned one level and
// wrote its 12 bytes of each point at a stride of L*12 bytes spent most of
// its time on those scattered stores (PERF.md keeps the times of the
// designs that lost).  So a cluster of 2 blocks
// holds 2 levels of one chunk: each block encodes a tile of 1024 points at
// its level and stores each point's 3 floats into the buffer of the block
// that owns the point's half of the tile (distributed shared memory); after
// a cluster barrier each block writes its 512 points' 2 levels as runs of
// 24 bytes.  Clusters of 4 and 8 (longer runs) ran slower: the barrier
// waits on more blocks each tile, and only 15 clusters of 8 fit at once
// (PERF.md).
//
// K4b zeroes a slice of the same size, accumulates its points' 8 corners x
// 3 channels there with shared atomics, and adds the slice into the
// gradient in device memory once, as 16-byte vector atomics
// (atomicAdd(float4*), red.global.add.v4.f32), skipping all-zero chunks.
// A shared float atomic is a compare-and-swap loop on this card
// (ATOMS.CAST.SPIN): where the lanes of a warp share a lattice cell
// (clustered points, coarse levels) the warp sums each row's lanes first
// (peer_sum, warp_peers.cuh), else one __match_any_sync a point tells it
// that no lane needs to.  Its gradient reads are 12 bytes at a stride of
// L*12 too.
//
// K4b's flush is a vector atomic rather than per-chunk partials in a
// scratch [chunks, total, 3] that a second pass sums in chunk order.  That
// pass would fix the order in which the chunks' slices add up, but not the
// gradient's rounding: the shared atomics already add each slice's terms
// in the order its warps run, so neither flush gives the same bits from
// run to run (nor did the plain index_add_, which is atomic on the card).
// The scratch would cost a second launch and 2 x chunks x 2.98 MB of extra
// traffic (8 chunks at 2^18 points); PERF.md has its reduction's time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "warp_peers.cuh"

namespace {

namespace cg = cooperative_groups;
using n2m::peer_sum;

constexpr int kC = 3;            // channels of the merged table
constexpr int kMaxLevels = 64;   // levels of one launch

// One level: float32 lattice scale, first table row, dense corner side (0
// on hashed levels) and the level's row count (a power of two on hashed
// levels, a multiple of 8 on every level).  The host passes an array of
// these (pallas_encode._level_records).
struct SweepLevel {
  float scale;
  int32_t offset;
  uint32_t side;
  uint32_t size;
};

struct SweepParams {
  SweepLevel lv[kMaxLevels];
};

// Lattice cell g and fractions fr of point p at level lv (x*scale + shift
// rounded as PyTorch rounds it); false out of bounds.
__device__ __forceinline__ bool sweep_cell(const float* __restrict__ x,
                                           int64_t p, const SweepLevel& lv,
                                           float shift, uint32_t g[3],
                                           float fr[3]) {
  const float xs[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  if (xs[0] < 0.f || xs[0] > 1.f || xs[1] < 0.f || xs[1] > 1.f ||
      xs[2] < 0.f || xs[2] > 1.f)
    return false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xs[d], lv.scale), shift);
    const float fl = floorf(pos);
    fr[d] = __fsub_rn(pos, fl);
    g[d] = static_cast<uint32_t>(fl);
  }
  return true;
}

// Level-local row of corner k (bit d = offset along axis d) of cell g.
__device__ __forceinline__ uint32_t corner_row(const SweepLevel& lv,
                                               const uint32_t g[3], int k) {
  const uint32_t cx = g[0] + (k & 1), cy = g[1] + ((k >> 1) & 1),
                 cz = g[2] + ((k >> 2) & 1);
  if (lv.side == 0)
    return ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) & (lv.size - 1u);
  const uint32_t idx = cx + cy * lv.side + cz * lv.side * lv.side;
  return idx >= lv.size ? idx % lv.size : idx;   // only a tiled grid wraps
}

__device__ __forceinline__ float corner_weight(const float fr[3], int k) {
  const float wx = (k & 1) ? fr[0] : __fsub_rn(1.0f, fr[0]);
  const float wy = ((k >> 1) & 1) ? fr[1] : __fsub_rn(1.0f, fr[1]);
  const float wz = ((k >> 2) & 1) ? fr[2] : __fsub_rn(1.0f, fr[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// Features of point p at level lv from its slice `rows` ([size, 3] in
// shared memory); zero out of bounds.
__device__ __forceinline__ void sweep_point(const float* __restrict__ x,
                                            int64_t p, const SweepLevel& lv,
                                            float shift, const float* rows,
                                            float a[3]) {
  a[0] = a[1] = a[2] = 0.f;
  uint32_t g[3];
  float fr[3];
  if (!sweep_cell(x, p, lv, shift, g, fr)) return;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight(fr, k);
    const float* r = rows + corner_row(lv, g, k) * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) a[c] = __fadd_rn(a[c], __fmul_rn(w, r[c]));
  }
}

// Copies a level's slice, n4 16-byte chunks, from device to shared memory
// with cp.async and waits for it; the block's barrier follows.
__device__ __forceinline__ void stage_slice(float4* dst, const float4* src,
                                            int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + i));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Calls launch(params, level0, n_lv, slice_bytes) for each group of at most
// kMaxLevels levels of the host records: its packed records and its
// largest slice's bytes.  Offsets and sizes must be multiples of 4 rows, so
// that a slice is whole 16-byte chunks (ref level sizes are multiples of 8).
template <typename Launch>
cudaError_t each_level_group(const SweepLevel* levels, int n_levels,
                             Launch launch) {
  for (int l0 = 0; l0 < n_levels; l0 += kMaxLevels) {
    const int n_lv = std::min(kMaxLevels, n_levels - l0);
    SweepParams sp{};
    int bytes = 0;
    for (int k = 0; k < n_lv; ++k) {
      const SweepLevel& lv = levels[l0 + k];
      if (lv.offset % 4 != 0 || lv.size % 4 != 0 || lv.size == 0)
        return cudaErrorInvalidValue;
      sp.lv[k] = lv;
      bytes = std::max(bytes, static_cast<int>(lv.size) * kC * 4);
    }
    const cudaError_t e = launch(sp, l0, n_lv, bytes);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

constexpr int kThreads = 1024;      // threads of a block: one point each a tile
constexpr int kPair = 2;            // blocks (levels) of a K4 cluster
// one tile buffer: a block's half of a tile, kThreads / 2 points of 6 floats
constexpr int kBufFloats = kThreads * kC;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// K4.  Cluster k of the grid (two blocks) takes the level pair h = k %
// n_pairs (launch levels 2h and 2h + 1; the second block of a last odd
// pair has none) of the point chunk c = k / n_pairs; its block of rank r
// takes launch level 2h + r.  Each block stages its level's slice, then
// walks the chunk a tile of kThreads points at a time, one point a thread.
// Block o owns the tile's points [o*T/2, (o+1)*T/2): both blocks store
// their level's 3 floats of each point into the owner's buffer
// (distributed shared memory), the pair meets at a cluster barrier, and
// each owner writes its points' 6 floats as one contiguous run a point.
// Two buffers, and the next tile is encoded between the barrier's arrive
// and wait.
__global__ void __cluster_dims__(kPair, 1, 1) __launch_bounds__(kThreads, 1)
sweep_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                 const __grid_constant__ SweepParams sp, int level0, int n_lv,
                 int n_levels, float shift, int64_t n_points, int64_t chunk,
                 int slice_floats, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* slice = reinterpret_cast<float*>(smem4);
  float* bufs = slice + slice_floats;                 // [2][kBufFloats]
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int n_pairs = (n_lv + 1) / kPair;
  const int64_t k = blockIdx.x / kPair;
  const int h = static_cast<int>(k % n_pairs);
  const int64_t c = k / n_pairs;
  const int li = h * kPair + r;
  const int width = min(kPair, n_lv - h * kPair) * kC;   // floats a point
  const bool has_level = li < n_lv;
  const SweepLevel lv = sp.lv[has_level ? li : 0];
  if (has_level)
    stage_slice(smem4,
                     reinterpret_cast<const float4*>(
                         table + static_cast<int64_t>(lv.offset) * kC),
                     static_cast<int>(lv.size * kC / 4));
  cluster.sync();   // both blocks run before any remote store

  const int64_t p0 = c * chunk;
  const int64_t p1 = p0 + chunk < n_points ? p0 + chunk : n_points;
  const int64_t stride = static_cast<int64_t>(n_levels) * kC;
  constexpr int kHalf = kThreads / kPair;
  // where this thread's point goes: its owner's buffer, at its row
  const int owner = threadIdx.x / kHalf;
  float* dst0 = cluster.map_shared_rank(bufs, owner) +
                (threadIdx.x - owner * kHalf) * width + r * kC;
  float* o = out + static_cast<int64_t>(level0 + h * kPair) * kC;
  float a[3] = {0.f, 0.f, 0.f};
  if (has_level && p0 + threadIdx.x < p1)
    sweep_point(x, p0 + threadIdx.x, lv, shift, slice, a);
  for (int64_t t0 = p0, t = 0; t0 < p1; t0 += kThreads, ++t) {
    if (has_level) {
      float* dst = dst0 + (t & 1) * kBufFloats;
      dst[0] = a[0];
      dst[1] = a[1];
      dst[2] = a[2];
    }
    cluster_arrive();
    // the next tile's point, while the other block stores its own; its
    // buffer's last reader arrived at this tile's barrier before
    const int64_t pn = t0 + kThreads + threadIdx.x;
    if (has_level && pn < p1) sweep_point(x, pn, lv, shift, slice, a);
    cluster_wait();
    const float* buf = bufs + (t & 1) * kBufFloats;
    const int64_t q0 = t0 + static_cast<int64_t>(r) * kHalf;
    const int64_t q1 = q0 + kHalf < p1 ? q0 + kHalf : p1;
    const int n = q1 > q0 ? static_cast<int>(q1 - q0) * width : 0;
    for (int j = threadIdx.x; j < n; j += kThreads)
      o[(q0 + j / width) * stride + j % width] = buf[j];
  }
}

// K4b.  Block b takes launch level b % n_lv of the point chunk b / n_lv; the
// level's slice of the gradient is accumulated in shared memory and
// flushed once.
__global__ void __launch_bounds__(kThreads, 1)
sweep_bwd_kernel(const float* __restrict__ grad, const float* __restrict__ x,
                 const __grid_constant__ SweepParams sp, int level0, int n_lv,
                 int n_levels, float shift, int64_t n_points, int64_t chunk,
                 float* __restrict__ dtable) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int li = static_cast<int>(blockIdx.x % n_lv);
  const int64_t c = blockIdx.x / n_lv;
  const SweepLevel lv = sp.lv[li];
  const int n4 = static_cast<int>(lv.size * kC / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t p1 = (c + 1) * chunk < n_points ? (c + 1) * chunk : n_points;
  const int64_t stride = static_cast<int64_t>(n_levels) * kC;
  const float* gl = grad + static_cast<int64_t>(level0 + li) * kC;
  // the loop is block-uniform, so every lane of a warp reaches the shuffles
  for (int64_t pb = c * chunk; pb < p1; pb += blockDim.x) {
    const int64_t p = pb + threadIdx.x;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (p < p1) {
      g0 = gl[p * stride];
      g1 = gl[p * stride + 1];
      g2 = gl[p * stride + 2];
    }
    uint32_t cell[3] = {0u, 0u, 0u};
    float fr[3] = {0.f, 0.f, 0.f};
    const bool live = (g0 != 0.f || g1 != 0.f || g2 != 0.f) &&
                      sweep_cell(x, p, lv, shift, cell, fr);
    // rows are below 2^31, so a dead lane's key matches no other lane's
    const unsigned key0 =
        live ? corner_row(lv, cell, 0) : 0x80000000u | lane;
    const bool alone =
        __all_sync(0xffffffffu, __match_any_sync(0xffffffffu, key0) == 1u << lane);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t row = live ? corner_row(lv, cell, k) : 0u;
      const float w = live ? corner_weight(fr, k) : 0.f;
      float v[3] = {__fmul_rn(w, g0), __fmul_rn(w, g1), __fmul_rn(w, g2)};
      bool add = live;
      if (!alone) {       // warp-uniform
        const unsigned peers =
            __match_any_sync(0xffffffffu, live ? row : 0x80000000u | lane);
        add = peer_sum(peers, v) && live;
      }
      if (add) {
        atomicAdd(acc + row * kC, v[0]);
        atomicAdd(acc + row * kC + 1, v[1]);
        atomicAdd(acc + row * kC + 2, v[2]);
      }
    }
  }
  __syncthreads();

  float4* dst = reinterpret_cast<float4*>(
      dtable + static_cast<int64_t>(lv.offset) * kC);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = acc4[i];
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      atomicAdd(dst + i, v);
  }
}

int64_t chunk_points(int64_t n_points, int64_t chunks) {
  return (n_points + chunks - 1) / chunks;
}

}  // namespace

// table: [total, 3] f32, 16-byte aligned; x: [n_points, 3] f32 (any values;
// points outside [0,1]^3 give zeros); levels: HOST array [n_levels] of {f32
// lattice scale, i32 first table row, u32 dense corner side or 0 on a
// hashed level, u32 row count}, offsets and sizes multiples of 4 rows and
// sizes at most 16384 rows, n_levels >= 1; chunks >= 1: point chunks per
// level (pallas_encode.sweep_chunks); out: [n_points, n_levels, 3] f32.
extern "C" int n2m_sweep_fwd(const void* table, const void* x,
                             const void* levels, float shift,
                             int64_t n_points, int n_levels, int64_t chunks,
                             void* out, void* stream) {
  if (n_levels < 1 || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_points == 0) return static_cast<int>(cudaGetLastError());
  const int64_t chunk = chunk_points(n_points, chunks);
  const int64_t n_chunks = chunk_points(n_points, chunk);
  return static_cast<int>(each_level_group(
      static_cast<const SweepLevel*>(levels), n_levels,
      [&](const SweepParams& sp, int l0, int n_lv, int bytes) {
        const int smem = bytes + 2 * kBufFloats * 4;
        const cudaError_t e = cudaFuncSetAttribute(
            sweep_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return e;
        const int64_t blocks = n_chunks * ((n_lv + 1) / kPair) * kPair;
        sweep_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(table), static_cast<const float*>(x), sp,
            l0, n_lv, n_levels, shift, n_points, chunk, bytes / 4,
            static_cast<float*>(out));
        return cudaGetLastError();
      }));
}

// grad: [n_points, n_levels, 3] f32; dtable: [total, 3] f32, 16-byte
// aligned, zeroed by the caller and accumulated into.  Other arguments as
// n2m_sweep_fwd.
extern "C" int n2m_sweep_bwd(const void* grad, const void* x,
                             const void* levels, float shift,
                             int64_t n_points, int n_levels, int64_t chunks,
                             void* dtable, void* stream) {
  if (n_levels < 1 || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dtable) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_points == 0) return static_cast<int>(cudaGetLastError());
  const int64_t chunk = chunk_points(n_points, chunks);
  const int64_t n_chunks = chunk_points(n_points, chunk);
  return static_cast<int>(each_level_group(
      static_cast<const SweepLevel*>(levels), n_levels,
      [&](const SweepParams& sp, int l0, int n_lv, int bytes) {
        const cudaError_t e = cudaFuncSetAttribute(
            sweep_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (e != cudaSuccess) return e;
        sweep_bwd_kernel<<<static_cast<unsigned>(n_chunks * n_lv), kThreads,
                           bytes, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(grad), static_cast<const float*>(x), sp,
            l0, n_lv, n_levels, shift, n_points, chunk,
            static_cast<float*>(dtable));
        return cudaGetLastError();
      }));
}
