// K5 winsort_fwd and K6 winsort_bwd: the in-block part of trilinear block512
// hash-grid interpolation on window-sorted fine levels, and its table
// gradient.
//
// Replaces: nerf2mesh_tpu/ops/splat_encode.py `_ws_fwd_kernel` (via
// _ws_level_fwd / _inwin_ws) and `_ws_bwd_kernel` (via _ws_level_bwd).  On
// the TPU those contract one VMEM-resident [24, 64] window per slot against
// the separable weights of a 128-point tile, masked by each point's window
// id, on the MXU.
//
// Contract (that of splat_encode_raw's winsort branch): per winsort level,
// the points are sorted by the window id of their own 8^3 block (`perm`,
// `wins`); tile t of the sorted order has two slots, its first and last
// point's window clamped to >= 0 (`slots`).  A point whose window equals one
// of its tile's slots sums its in-block corners: those whose local lattice
// coordinate (g & 7) + bit stays <= 7 on every axis, read from the canonical
// [total, 3] table at offsets[l] + win*512 + lx + 8*ly + 64*lz.  Every other
// corner, and every corner of a point outside the slots (oob points have
// window -1 and never match), adds 0 here and is left to the residual that
// splat_encode_raw computes in PyTorch.  The result is written at the
// point's position in the caller's order, out[perm[i], k].
//
// Bound on the H100: memory latency.  Per (point, level) the kernel reads
// 12 B of position at a scattered index, 3 ints of sort metadata, does ~60
// flops and up to 8 corner reads of 12 B from one 6 KB window; the window-
// sorted order puts a warp's 32 points on one or two windows, so the corner
// reads share L2 lines.  The backward is bound by its float atomics: with
// 2^18 points and 1024 windows a level, ~256 points add into each window's
// 512 rows, and the lanes of a warp add into the same window.
//
// Design: one thread per (winsort level, sorted point), level-major, so a
// warp walks 32 neighbours in the window-sorted order.  The lattice position
// is __fadd_rn(__fmul_rn(x, s), shift), as in K2: PyTorch decides which
// corners cross the block edge (the residual) with a separately rounded
// multiply and add, and one floor that differed would count a corner twice
// or drop it silently.  The backward adds with atomicAdd into a zeroed fp32
// [total, 3] gradient: the TPU's sequential grid made its read-modify-write
// of a window race-free, the GPU's blocks run in parallel.
#include <cuda_runtime.h>
#include <cstdint>

#include "level_params.cuh"

namespace {

using n2m::blocks_for;
using n2m::kTile;
using n2m::LevelParams;
using n2m::pack_levels;

// For sorted point i of winsort level k: does nothing if the point's window
// is not one of its tile's slots; otherwise reads the point through perm and
// calls fn(row, w) for each of its in-block corners.
template <typename Fn>
__device__ __forceinline__ void for_inblock_corners(
    const float* __restrict__ x, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ wins, const int32_t* __restrict__ slots,
    const LevelParams& lp, float shift, int64_t n_points, int64_t n_tiles,
    int k, int64_t i, Fn fn) {
  const int64_t ki = static_cast<int64_t>(k) * n_points + i;
  const int32_t win = wins[ki];
  const int32_t* s = slots + (static_cast<int64_t>(k) * n_tiles + i / kTile) * 2;
  if (win != s[0] && win != s[1]) return;
  const int64_t p = perm[ki];
  const float sc = lp.scale[k];
  int lg[3];
  float fr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[p * 3 + d], sc), shift);
    const float g = floorf(pos);
    fr[d] = __fsub_rn(pos, g);
    lg[d] = static_cast<int>(g) & 7;
  }
  const int64_t base = lp.offset[k] + static_cast<int64_t>(win) * 512;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
    const int lx = lg[0] + bx, ly = lg[1] + by, lz = lg[2] + bz;
    if (lx > 7 || ly > 7 || lz > 7) continue;   // crosses the block edge
    const float wx = bx ? fr[0] : __fsub_rn(1.0f, fr[0]);
    const float wy = by ? fr[1] : __fsub_rn(1.0f, fr[1]);
    const float wz = bz ? fr[2] : __fsub_rn(1.0f, fr[2]);
    fn(base + lx + 8 * ly + 64 * lz, __fmul_rn(__fmul_rn(wx, wy), wz));
  }
}

__global__ void winsort_fwd_kernel(const float* __restrict__ table,
                                   const float* __restrict__ x,
                                   const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ wins,
                                   const int32_t* __restrict__ slots,
                                   const __grid_constant__ LevelParams lp,
                                   float shift, int64_t n_points,
                                   int64_t n_tiles, int n_levels,
                                   float* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_points * n_levels) return;
  const int k = static_cast<int>(tid / n_points);
  const int64_t i = tid - static_cast<int64_t>(k) * n_points;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for_inblock_corners(x, perm, wins, slots, lp, shift, n_points, n_tiles, k, i,
                      [&](int64_t row, float w) {
                        a0 = __fadd_rn(a0, __fmul_rn(w, __ldg(table + row * 3)));
                        a1 = __fadd_rn(a1, __fmul_rn(w, __ldg(table + row * 3 + 1)));
                        a2 = __fadd_rn(a2, __fmul_rn(w, __ldg(table + row * 3 + 2)));
                      });
  const int64_t o = (static_cast<int64_t>(perm[tid]) * n_levels + k) * 3;
  out[o] = a0;
  out[o + 1] = a1;
  out[o + 2] = a2;
}

__global__ void winsort_bwd_kernel(const float* __restrict__ grad,
                                   const float* __restrict__ x,
                                   const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ wins,
                                   const int32_t* __restrict__ slots,
                                   const __grid_constant__ LevelParams lp,
                                   float shift, int64_t n_points,
                                   int64_t n_tiles, int n_levels,
                                   float* __restrict__ dtable) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_points * n_levels) return;
  const int k = static_cast<int>(tid / n_points);
  const int64_t i = tid - static_cast<int64_t>(k) * n_points;
  const int64_t o = (static_cast<int64_t>(perm[tid]) * n_levels + k) * 3;
  const float g0 = grad[o], g1 = grad[o + 1], g2 = grad[o + 2];
  if (g0 == 0.f && g1 == 0.f && g2 == 0.f) return;   // e.g. out-of-bounds points
  for_inblock_corners(x, perm, wins, slots, lp, shift, n_points, n_tiles, k, i,
                      [&](int64_t row, float w) {
                        atomicAdd(dtable + row * 3, __fmul_rn(g0, w));
                        atomicAdd(dtable + row * 3 + 1, __fmul_rn(g1, w));
                        atomicAdd(dtable + row * 3 + 2, __fmul_rn(g2, w));
                      });
}

}  // namespace

// table: [total, 3] f32; x: [n_points, 3] f32 clipped to [0,1], any order,
// n_points = 128 * n_tiles; perm: [n_levels, n_points] i32, per level the
// window-sorted order (a permutation of 0..n_points-1); wins: [n_levels,
// n_points] i32 window id of each sorted point (-1 out of bounds); slots:
// [n_levels, n_tiles, 2] i32 (>= 0); scales, offsets: HOST arrays [n_levels]
// (f32 lattice scale, i32 first table row of the level), 1 <= n_levels <= 32;
// out: [n_points, n_levels, 3] f32 in x's order.
extern "C" int n2m_winsort_fwd(const void* table, const void* x,
                               const void* perm, const void* wins,
                               const void* slots, const float* scales,
                               const int32_t* offsets, float shift,
                               int64_t n_points, int64_t n_tiles, int n_levels,
                               void* out, void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = n_points * n_levels;
  if (n > 0) {
    const int threads = 256;
    winsort_fwd_kernel<<<blocks_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(x),
        static_cast<const int32_t*>(perm), static_cast<const int32_t*>(wins),
        static_cast<const int32_t*>(slots), lp, shift, n_points, n_tiles,
        n_levels, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// grad: [n_points, n_levels, 3] f32 in x's order; dtable: [total, 3] f32,
// zeroed by the caller and accumulated into.  Other arguments as
// n2m_winsort_fwd.
extern "C" int n2m_winsort_bwd(const void* grad, const void* x,
                               const void* perm, const void* wins,
                               const void* slots, const float* scales,
                               const int32_t* offsets, float shift,
                               int64_t n_points, int64_t n_tiles, int n_levels,
                               void* dtable, void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = n_points * n_levels;
  if (n > 0) {
    const int threads = 256;
    winsort_bwd_kernel<<<blocks_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grad), static_cast<const float*>(x),
        static_cast<const int32_t*>(perm), static_cast<const int32_t*>(wins),
        static_cast<const int32_t*>(slots), lp, shift, n_points, n_tiles,
        n_levels, static_cast<float*>(dtable));
  }
  return static_cast<int>(cudaGetLastError());
}
