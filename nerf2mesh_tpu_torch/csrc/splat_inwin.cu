// K2 inwin_fwd and K3 inwin_bwd: the in-window part of trilinear block512
// hash-grid interpolation, and its table gradient.
//
// Replaces: nerf2mesh_tpu/ops/splat_encode.py `_fwd_kernel` (via
// _level_pallas_fwd / _inwin) and `_bwd_kernel` (via _level_pallas_bwd).
// On the TPU those contract VMEM-resident 2x2x2 windows of 8^3 table blocks
// against separable one-hot weights on the MXU, one 128-point tile at a time.
//
// Contract (that of windowed_reference): a tile of 128 points has a base
// block `base` per level (tile_meta); a corner whose local lattice coordinate
// c - 8*base lies in [0,16)^3 belongs to window slot sx + 2*sy + 4*sz and is
// read from the canonical [total, 3] table at
//     offsets[l] + rows[slot]*512 + (cx&7) + 8*(cy&7) + 64*(cz&7);
// every other corner adds 0 here and is left to the residual that
// splat_encode_raw computes in PyTorch.  Reading the canonical table directly
// removes the [Wtot, 24, 64] splat transpose of the whole table per step.
//
// Bound on the H100: memory latency of the random table reads.  Per
// (point, level) the kernel reads 12 B of position, does ~60 flops and up to
// 8 corner reads of 12 B each from a table of up to 2^19 * 3 * 4 B = 6 MB per
// level, all of which fit the 50 MB L2 together; the forward is bound by L2
// latency, the backward by the throughput of its float atomics.
//
// Design: one thread per (point, kernel level), threads ordered point-major so
// that a warp's 32 lanes read neighbouring morton-sorted points whose corners
// share table lines.  No shared-memory window staging yet (later work).  The
// lattice position x*scale + shift is computed with __fmul_rn/__fadd_rn so
// that nvcc cannot contract it into an FMA: PyTorch decides which corners are
// out of window (the residual) with a separately rounded multiply and add, and
// one floor that differed would count a corner twice or drop it silently.
// The backward adds with atomicAdd into a zeroed fp32 [total, 3] gradient: on
// the TPU K3's read-modify-writes were race-free only because its grid ran in
// order; here tiles run in parallel and two slots of one tile, or two tiles,
// can share a window (hashed levels), so the adds must be atomic.
#include <cuda_runtime.h>
#include <cstdint>

#include "level_params.cuh"

namespace {

using n2m::blocks_for;
using n2m::kTile;
using n2m::LevelParams;
using n2m::pack_levels;

// Walks the 8 corners of point p at kernel level k; calls fn(row, w) for each
// in-window corner.  Returns nothing: out-of-window corners are skipped.
template <typename Fn>
__device__ __forceinline__ void for_inwin_corners(
    const float* __restrict__ x, const int32_t* __restrict__ bases,
    const int32_t* __restrict__ rows, const LevelParams& lp, float shift,
    int64_t p, int k, int64_t n_tiles, Fn fn) {
  const int64_t t = p / kTile;
  const float s = lp.scale[k];
  const int32_t* b = bases + (static_cast<int64_t>(k) * n_tiles + t) * 3;
  const int32_t* r = rows + (static_cast<int64_t>(k) * n_tiles + t) * 8;
  const int64_t off = lp.offset[k];
  int lg[3];
  float fr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[p * 3 + d], s), shift);
    const float g = floorf(pos);
    fr[d] = __fsub_rn(pos, g);
    lg[d] = static_cast<int>(g) - 8 * b[d];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
    const int lx = lg[0] + bx, ly = lg[1] + by, lz = lg[2] + bz;
    if (lx < 0 || lx >= 16 || ly < 0 || ly >= 16 || lz < 0 || lz >= 16)
      continue;
    const float wx = bx ? fr[0] : __fsub_rn(1.0f, fr[0]);
    const float wy = by ? fr[1] : __fsub_rn(1.0f, fr[1]);
    const float wz = bz ? fr[2] : __fsub_rn(1.0f, fr[2]);
    const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
    const int slot = (lx >> 3) + 2 * (ly >> 3) + 4 * (lz >> 3);
    const int64_t row = off + static_cast<int64_t>(r[slot]) * 512 +
                        (lx & 7) + 8 * (ly & 7) + 64 * (lz & 7);
    fn(row, w);
  }
}

__global__ void inwin_fwd_kernel(const float* __restrict__ table,
                                 const float* __restrict__ x,
                                 const int32_t* __restrict__ bases,
                                 const int32_t* __restrict__ rows,
                                 const __grid_constant__ LevelParams lp,
                                 float shift, int64_t n_points,
                                 int64_t n_tiles, int n_levels,
                                 float* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_points * n_levels) return;
  const int64_t p = tid / n_levels;
  const int k = static_cast<int>(tid - p * n_levels);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for_inwin_corners(x, bases, rows, lp, shift, p, k, n_tiles,
                    [&](int64_t row, float w) {
                      a0 = __fadd_rn(a0, __fmul_rn(w, __ldg(table + row * 3)));
                      a1 = __fadd_rn(a1, __fmul_rn(w, __ldg(table + row * 3 + 1)));
                      a2 = __fadd_rn(a2, __fmul_rn(w, __ldg(table + row * 3 + 2)));
                    });
  out[tid * 3] = a0;
  out[tid * 3 + 1] = a1;
  out[tid * 3 + 2] = a2;
}

__global__ void inwin_bwd_kernel(const float* __restrict__ grad,
                                 const float* __restrict__ x,
                                 const int32_t* __restrict__ bases,
                                 const int32_t* __restrict__ rows,
                                 const __grid_constant__ LevelParams lp,
                                 float shift, int64_t n_points,
                                 int64_t n_tiles, int n_levels,
                                 float* __restrict__ dtable) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_points * n_levels) return;
  const int64_t p = tid / n_levels;
  const int k = static_cast<int>(tid - p * n_levels);
  const float g0 = grad[tid * 3], g1 = grad[tid * 3 + 1], g2 = grad[tid * 3 + 2];
  if (g0 == 0.f && g1 == 0.f && g2 == 0.f) return;   // e.g. out-of-bounds points
  for_inwin_corners(x, bases, rows, lp, shift, p, k, n_tiles,
                    [&](int64_t row, float w) {
                      atomicAdd(dtable + row * 3, __fmul_rn(g0, w));
                      atomicAdd(dtable + row * 3 + 1, __fmul_rn(g1, w));
                      atomicAdd(dtable + row * 3 + 2, __fmul_rn(g2, w));
                    });
}

}  // namespace

// table: [total, 3] f32; x: [n_points, 3] f32 clipped to [0,1], morton-sorted,
// n_points = 128 * n_tiles; bases: [n_levels, n_tiles, 3] i32; rows:
// [n_levels, n_tiles, 8] i32 level-local window ids; scales, offsets: HOST
// arrays [n_levels] (f32 lattice scale, i32 first table row of the level),
// 1 <= n_levels <= 32; out: [n_points, n_levels, 3] f32.
extern "C" int n2m_inwin_fwd(const void* table, const void* x,
                             const void* bases, const void* rows,
                             const float* scales, const int32_t* offsets,
                             float shift, int64_t n_points, int64_t n_tiles,
                             int n_levels, void* out, void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = n_points * n_levels;
  if (n > 0) {
    const int threads = 256;
    inwin_fwd_kernel<<<blocks_for(n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(x),
        static_cast<const int32_t*>(bases), static_cast<const int32_t*>(rows),
        lp, shift, n_points, n_tiles, n_levels, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// grad: [n_points, n_levels, 3] f32; dtable: [total, 3] f32, zeroed by the
// caller and accumulated into.  Other arguments as n2m_inwin_fwd.
extern "C" int n2m_inwin_bwd(const void* grad, const void* x,
                             const void* bases, const void* rows,
                             const float* scales, const int32_t* offsets,
                             float shift, int64_t n_points, int64_t n_tiles,
                             int n_levels, void* dtable, void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = n_points * n_levels;
  if (n > 0) {
    const int threads = 256;
    inwin_bwd_kernel<<<blocks_for(n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grad), static_cast<const float*>(x),
        static_cast<const int32_t*>(bases), static_cast<const int32_t*>(rows),
        lp, shift, n_points, n_tiles, n_levels, static_cast<float*>(dtable));
  }
  return static_cast<int>(cudaGetLastError());
}
