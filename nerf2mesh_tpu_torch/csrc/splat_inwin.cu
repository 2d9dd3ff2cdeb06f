// K2 inwin_fwd and K3 inwin_bwd: the in-window part of trilinear block512
// hash-grid interpolation, and its table gradient.
//
// Replaces: nerf2mesh_tpu/ops/splat_encode.py `_fwd_kernel` (via
// _level_pallas_fwd / _inwin) and `_bwd_kernel` (via _level_pallas_bwd).
// On the TPU those contract VMEM-resident 2x2x2 windows of 8^3 table blocks
// against separable one-hot weights on the MXU, one 128-point tile at a time;
// the backward's sequential grid reads, modifies and writes the tile's
// windows in VMEM, one [48, 64] product per slot pair.
//
// Contract (that of windowed_reference): a tile of 128 points has a base
// block `base` per level (tile_meta); a corner whose local lattice coordinate
// c - 8*base lies in [0,16)^3 belongs to window slot sx + 2*sy + 4*sz and is
// read from the canonical [total, C] table (C = 1, 2 or 3 channels: the
// separate density and colour tables, or the merged one) at
//     offsets[l] + rows[slot]*512 + (cx&7) + 8*(cy&7) + 64*(cz&7);
// every other corner adds 0 here and is left to the residual that
// splat_encode_raw computes in PyTorch.  Reading the canonical table directly
// removes the [Wtot, 24, 64] splat transpose of the whole table per step.
//
// The lattice position x*scale + shift is computed with __fmul_rn/__fadd_rn
// so that nvcc cannot contract it into an FMA: PyTorch decides which corners
// are out of window (the residual) with a separately rounded multiply and
// add, and one floor that differed would count a corner twice or drop it.
//
// Both kernels are templates on C with one instantiation for each of C = 1,
// 2 and 3; the numbers below are C = 3's (a row is 4C bytes).
//
// K2, bound on the H100: the corner reads and the issue of its
// instructions.  Per (point, level) it reads 12 B of position, makes up to
// 8 corner reads of 12 B from a level of up to 2^19 * 12 B = 6 MB, does
// ~350 instructions of lattice, weights and addresses, and writes 12 B.
// One block of 256 threads takes one 128-point tile at all its kernel
// levels; each warp takes 32 consecutive morton-sorted points at one level
// at a time, so that a warp's corner loads fall on the few blocks of one
// level around the tile (a warp of ~3.5 points x 9 levels scatters them
// over nine tables).  The tile's x, bases and rows are read once into
// shared memory; the results go to shared memory as [128, Lk, C] (an odd
// stride a point, so the lanes' writes hit 32 banks) and leave as
// coalesced 16-byte stores: the tile's slice of out is contiguous, 512 * C
// * Lk bytes, a multiple of 16 at every C.  With every corner read from two windows it would still take
// ~70% of its time (PERF.md, PR 7): what is left is instruction issue.  On
// a few thousand points the grid is too small to fill the card.
//
// K3, bound on the H100: the adds into the [total, 3] gradient.  One float
// atomic per (point, corner, channel) in device memory was ~46M contended
// L2 atomics at 2^18 points and 9 levels (the 32 lanes of a warp mostly hit
// the same 8 rows; level 0 has 27 windows).  The design reduces on chip, as
// the TPU kernel did in VMEM: one thread block takes one tile at one kernel
// level, two threads a point (corners 0-3 and 4-7).  Warp 0 gives each
// distinct window id among the tile's 8 slots one shared [512, C] f32
// accumulator (2C KiB); slots of one id (hashed collisions) share it.  A
// float atomicAdd on shared memory is a compare-and-swap loop, so the lanes
// of a warp that add into one row would serialise: warp_add3 sums them with
// shuffles first (warp_peers.cuh), and the row's lowest lane adds the sum
// and marks the row's 16-byte chunks in a bitmask (a chunk spans 4/C rows,
// a row one or two chunks).  After a barrier the block adds each
// touched chunk into device memory as one 16-byte vector atomic
// (atomicAdd(float4*), red.global.add.v4.f32 on sm_90): ~2.6M adds at 2^18
// points in place of ~46M.  What bounds it now is not measured (PERF.md):
// the vector adds into the coarse windows that every block shares, or the
// shared CAS loops.  A window starts at row offsets[l] + win*512 with
// offsets[l] a multiple of 512 (level sizes are), so its first float is
// 16-byte aligned when the gradient is; the launcher checks both.  Dynamic
// shared memory: 16C KiB + 128C B, so four blocks fit an SM at C = 3.  (Blocks of 2
// and 4 consecutive tiles, which share their coarse windows, issued 12% and
// 20% fewer vector adds but ran 3-10% slower: PERF.md.)
#include <cuda_runtime.h>
#include <cstdint>

#include "level_params.cuh"
#include "warp_peers.cuh"

namespace {

using n2m::kTile;
using n2m::LevelParams;
using n2m::pack_levels;
using n2m::peer_sum;

// one window of a [total, C] table: its floats, its 16-byte chunks (128 C)
// and its touched-mask words (4 C)
template <int C>
struct Win {
  static constexpr int kFloats = 512 * C;
  static constexpr int kChunks = kFloats / 4;
  static constexpr int kWords = kChunks / 32;
};
constexpr int kFwdThreads = 256;             // K2: a block a tile
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdGroups = kTile / 32;       // a tile's 32-point warp groups

// Lattice cell of a point of position xp at lattice scale s, relative to
// the tile's base block b (8 * b): lg its coordinate, fr the fractions.
__device__ __forceinline__ void lattice_at(const float xp[3], const int32_t b[3],
                                           float s, float shift, int lg[3],
                                           float fr[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xp[d], s), shift);
    const float g = floorf(pos);
    fr[d] = __fsub_rn(pos, g);
    lg[d] = static_cast<int>(g) - 8 * b[d];
  }
}

// Lattice cell of point p at kernel level k: lg its coordinate relative to
// the tile's base block (8 * base), fr the fractions.
__device__ __forceinline__ void inwin_lattice(
    const float* __restrict__ x, const int32_t* __restrict__ bases,
    const LevelParams& lp, float shift, int64_t p, int k, int64_t n_tiles,
    int lg[3], float fr[3]) {
  const int32_t* b = bases + (static_cast<int64_t>(k) * n_tiles + p / kTile) * 3;
  const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  const int32_t bp[3] = {b[0], b[1], b[2]};
  lattice_at(xp, bp, lp.scale[k], shift, lg, fr);
}

// Corner c of the cell (bit d = offset along axis d): false if it lies out
// of the tile's 16^3 window neighbourhood; else its window slot, its row
// `cell` = (cx&7) + 8*(cy&7) + 64*(cz&7) in the slot's window, and weight w.
__device__ __forceinline__ bool inwin_corner(const int lg[3], const float fr[3],
                                             int c, int& slot, int& cell,
                                             float& w) {
  const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
  const int lx = lg[0] + bx, ly = lg[1] + by, lz = lg[2] + bz;
  if (lx < 0 || lx >= 16 || ly < 0 || ly >= 16 || lz < 0 || lz >= 16)
    return false;
  const float wx = bx ? fr[0] : __fsub_rn(1.0f, fr[0]);
  const float wy = by ? fr[1] : __fsub_rn(1.0f, fr[1]);
  const float wz = bz ? fr[2] : __fsub_rn(1.0f, fr[2]);
  w = __fmul_rn(__fmul_rn(wx, wy), wz);
  slot = (lx >> 3) + 2 * (ly >> 3) + 4 * (lz >> 3);
  cell = (lx & 7) + 8 * (ly & 7) + 64 * (lz & 7);
  return true;
}

// Block t = blockIdx.x takes tile t at every kernel level.  Dynamic shared
// memory: the tile's results, [kTile][stride] floats, stride = C * n_levels
// made odd.
template <int C>
__global__ void __launch_bounds__(kFwdThreads)
inwin_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                 const int32_t* __restrict__ bases,
                 const int32_t* __restrict__ rows,
                 const __grid_constant__ LevelParams lp, float shift,
                 int64_t n_tiles, int n_levels, float* __restrict__ out) {
  extern __shared__ float s_out[];
  __shared__ float4 s_x4[kTile * 3 / 4];
  __shared__ int32_t s_base[n2m::kMaxLevels * 3];
  __shared__ int32_t s_rows[n2m::kMaxLevels * 8];
  const int64_t t = blockIdx.x;
  const int l3 = 3 * n_levels;                  // bases of the tile's levels
  const int lc = C * n_levels;                  // a point's floats of out
  const int stride = lc | 1;
  if (threadIdx.x < kTile * 3 / 4)
    s_x4[threadIdx.x] = reinterpret_cast<const float4*>(x)[t * (kTile * 3 / 4) +
                                                           threadIdx.x];
  for (int i = threadIdx.x; i < l3; i += kFwdThreads)
    s_base[i] = bases[((i / 3) * n_tiles + t) * 3 + i % 3];
  for (int i = threadIdx.x; i < 8 * n_levels; i += kFwdThreads)
    s_rows[i] = rows[((i >> 3) * n_tiles + t) * 8 + (i & 7)];
  __syncthreads();

  const float* xs = reinterpret_cast<const float*>(s_x4);
  const int lane = threadIdx.x & 31;
  for (int it = threadIdx.x >> 5; it < n_levels * kFwdGroups; it += kFwdWarps) {
    const int k = it / kFwdGroups;
    const int p = (it % kFwdGroups) * 32 + lane;
    const float xp[3] = {xs[p * 3], xs[p * 3 + 1], xs[p * 3 + 2]};
    const int32_t bp[3] = {s_base[k * 3], s_base[k * 3 + 1], s_base[k * 3 + 2]};
    int lg[3];
    float fr[3];
    lattice_at(xp, bp, lp.scale[k], shift, lg, fr);
    const int64_t off = lp.offset[k];
    const int32_t* r = s_rows + 8 * k;
    float a[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) a[ch] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int slot, cell;
      float w;
      if (!inwin_corner(lg, fr, c, slot, cell, w)) continue;
      const float* v = table + (off + static_cast<int64_t>(r[slot]) * 512 + cell) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) a[ch] = __fadd_rn(a[ch], __fmul_rn(w, __ldg(v + ch)));
    }
    float* o = s_out + p * stride + C * k;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] = a[ch];
  }
  __syncthreads();

  // the tile's [kTile, n_levels, C] slice of out as 16-byte stores
  float4* dst = reinterpret_cast<float4*>(out + t * kTile * lc);
  for (int e4 = threadIdx.x; e4 < kTile * lc / 4; e4 += kFwdThreads) {
    int p = 4 * e4 / lc, r = 4 * e4 - p * lc;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = s_out[p * stride + r];
      if (++r == lc) r = 0, ++p;
    }
    dst[e4] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Adds v into the shared acc[C*row .. C*row+C-1] for each lane with
// `valid`, the lanes of one row summed first (peer_sum).  Every lane of the
// warp must call it (the caller's loop is warp-uniform).  Returns true on
// the lane that made its row's adds.
template <int C>
__device__ __forceinline__ bool warp_add(float* acc, int row, bool valid,
                                         float (&v)[C]) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? row : -1 - lane);
  if (!(peer_sum(peers, v) && valid)) return false;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) atomicAdd(acc + C * row + ch, v[ch]);
  return true;
}

__device__ __forceinline__ void mark_chunk(uint32_t* touched, int c) {
  atomicOr(touched + (c >> 5), 1u << (c & 31));
}

// Block (t, k) = blockIdx.x as t * n_levels + k, so the blocks of one tile
// at all levels run together and share the tile's x and grad lines.
// Thread (h, i) = threadIdx.x as h * 128 + i takes the corners 4h..4h+3 of
// point i of the tile: two threads a point, so that twice the warps hide
// the loads' latency at the same shared memory.
template <int C>
__global__ void __launch_bounds__(2 * kTile)
inwin_bwd_kernel(const float* __restrict__ grad, const float* __restrict__ x,
                 const int32_t* __restrict__ bases,
                 const int32_t* __restrict__ rows,
                 const __grid_constant__ LevelParams lp, float shift,
                 int64_t n_tiles, int n_levels, float* __restrict__ dtable) {
  constexpr int kChunks = Win<C>::kChunks, kWords = Win<C>::kWords;
  extern __shared__ float4 acc4[];                 // [n_win][128 C] float4
  float* acc = reinterpret_cast<float*>(acc4);
  uint32_t* touched = reinterpret_cast<uint32_t*>(acc4 + 8 * kChunks);
  __shared__ int32_t win_id[8];         // window id of each shared window
  __shared__ int32_t win_of[8];         // slot -> shared window
  __shared__ int n_win;

  const int k = static_cast<int>(blockIdx.x % n_levels);
  const int64_t t = blockIdx.x / n_levels;

  // one shared window per distinct window id among the tile's slots
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    const bool live = i < 8;
    const int32_t id = live ? rows[(static_cast<int64_t>(k) * n_tiles + t) * 8 + i]
                            : -1 - i;             // window ids are >= 0
    const unsigned same = __match_any_sync(0xffffffffu, id);
    const int leader = __ffs(same) - 1;
    const unsigned firsts = __ballot_sync(0xffffffffu, live && leader == i);
    const int u = __popc(firsts & ((1u << leader) - 1u));
    if (live) {
      win_of[i] = u;
      if (leader == i) win_id[u] = id;
    }
    if (i == 0) n_win = __popc(firsts);
  }
  __syncthreads();
  const int nw = n_win;
  for (int c = threadIdx.x; c < nw * kChunks; c += blockDim.x)
    acc4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = threadIdx.x; c < nw * kWords; c += blockDim.x) touched[c] = 0u;
  __syncthreads();

  const int h = threadIdx.x / kTile;
  const int64_t p = t * kTile + threadIdx.x % kTile;
  const float* gp = grad + (p * n_levels + k) * C;
  float g[C];
  bool live = false;                                       // e.g. oob points
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    g[ch] = gp[ch];
    live |= g[ch] != 0.f;
  }
  int lg[3] = {-64, -64, -64};
  float fr[3] = {0.f, 0.f, 0.f};
  if (live) inwin_lattice(x, bases, lp, shift, p, k, n_tiles, lg, fr);
#pragma unroll
  for (int c = 4 * h; c < 4 * h + 4; ++c) {   // warp-uniform: h is
    int slot = 0, cell = 0;
    float w = 0.f;
    const bool in = live && inwin_corner(lg, fr, c, slot, cell, w);
    const int u = in ? win_of[slot] : 0;
    float v[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = __fmul_rn(g[ch], w);
    if (warp_add<C>(acc, u * 512 + cell, in, v)) {
      const int c0 = u * kChunks + ((cell * C) >> 2);
      const int c1 = u * kChunks + ((cell * C + C - 1) >> 2);
      mark_chunk(touched, c0);
      if (c1 != c0) mark_chunk(touched, c1);
    }
  }
  __syncthreads();

  // one 16-byte vector add into device memory per touched chunk
  const int64_t offc = static_cast<int64_t>(lp.offset[k]) * C;
  for (int c = threadIdx.x; c < nw * kChunks; c += blockDim.x) {
    if (!((touched[c >> 5] >> (c & 31)) & 1u)) continue;
    const int u = c / kChunks;
    float* dst = dtable + offc + static_cast<int64_t>(win_id[u]) * Win<C>::kFloats +
                 4 * (c - u * kChunks);
    atomicAdd(reinterpret_cast<float4*>(dst), acc4[c]);
  }
}

}  // namespace

namespace {

template <int C>
cudaError_t launch_inwin_fwd(const void* table, const void* x, const void* bases,
                             const void* rows, const LevelParams& lp, float shift,
                             int64_t n_tiles, int n_levels, void* out,
                             cudaStream_t stream) {
  const int smem = kTile * ((C * n_levels) | 1) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        inwin_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  inwin_fwd_kernel<C><<<static_cast<unsigned>(n_tiles), kFwdThreads, smem, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(rows),
      lp, shift, n_tiles, n_levels, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_inwin_bwd(const void* grad, const void* x, const void* bases,
                             const void* rows, const LevelParams& lp, float shift,
                             int64_t n_tiles, int n_levels, void* dtable,
                             cudaStream_t stream) {
  const int smem = 8 * Win<C>::kFloats * 4 + 8 * Win<C>::kWords * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      inwin_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  inwin_bwd_kernel<C><<<static_cast<unsigned>(n_tiles * n_levels), 2 * kTile, smem,
                        stream>>>(
      static_cast<const float*>(grad), static_cast<const float*>(x),
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(rows), lp,
      shift, n_tiles, n_levels, static_cast<float*>(dtable));
  return cudaGetLastError();
}

}  // namespace

// table: [total, channels] f32, channels 1, 2 or 3; x: [n_points, 3] f32
// clipped to [0,1], morton-sorted, 16-byte aligned, n_points = 128 *
// n_tiles; bases: [n_levels, n_tiles, 3] i32; rows: [n_levels, n_tiles, 8]
// i32 level-local window ids; scales, offsets: HOST arrays [n_levels] (f32
// lattice scale, i32 first table row of the level), 1 <= n_levels <= 32;
// out: [n_points, n_levels, channels] f32, 16-byte aligned.
extern "C" int n2m_inwin_fwd(const void* table, const void* x,
                             const void* bases, const void* rows,
                             const float* scales, const int32_t* offsets,
                             float shift, int64_t n_points, int64_t n_tiles,
                             int n_levels, int channels, void* out,
                             void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points != n_tiles * kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (channels < 1 || channels > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      channels == 1 ? launch_inwin_fwd<1>(table, x, bases, rows, lp, shift, n_tiles,
                                          n_levels, out, st)
      : channels == 2 ? launch_inwin_fwd<2>(table, x, bases, rows, lp, shift, n_tiles,
                                            n_levels, out, st)
                      : launch_inwin_fwd<3>(table, x, bases, rows, lp, shift, n_tiles,
                                            n_levels, out, st);
  return static_cast<int>(e);
}

// grad: [n_points, n_levels, channels] f32; dtable: [total, channels] f32,
// 16-byte aligned, zeroed by the caller and accumulated into; every
// offsets[k] a multiple of 4 rows.  Other arguments as n2m_inwin_fwd.
extern "C" int n2m_inwin_bwd(const void* grad, const void* x,
                             const void* bases, const void* rows,
                             const float* scales, const int32_t* offsets,
                             float shift, int64_t n_points, int64_t n_tiles,
                             int n_levels, int channels, void* dtable,
                             void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dtable) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int k = 0; k < n_levels; ++k)
    if (offsets[k] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points != n_tiles * kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (channels < 1 || channels > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      channels == 1 ? launch_inwin_bwd<1>(grad, x, bases, rows, lp, shift, n_tiles,
                                          n_levels, dtable, st)
      : channels == 2 ? launch_inwin_bwd<2>(grad, x, bases, rows, lp, shift, n_tiles,
                                            n_levels, dtable, st)
                      : launch_inwin_bwd<3>(grad, x, bases, rows, lp, shift, n_tiles,
                                            n_levels, dtable, st);
  return static_cast<int>(e);
}
