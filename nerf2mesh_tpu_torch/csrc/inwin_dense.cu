// K7 inwin_dense: K2's in-window features [N, 1, 3] at one level, computed
// as the TPU computes them, by the dense window contraction.
//
// Replaces: workspace/ab/microbench_kernel_variants.py `_kern_b` (:64, one
// deep [48,256] x [256,128] product a tile), `_kern_c` (:109, the
// constant-row probe: every slot pair reads windows 0 and 1) and `_kern_d`
// (:149, the 4-product form with 4 tiles a grid step): the TPU's timing
// variants of K2's MXU formulation (`_fwd_kernel`, splat_encode.py:234-256).
// No path of the system runs them; chip_smoke.py times them beside K2.
//
// What a tile does: stage its 8 slot windows in shared memory as the left
// operand lhs[k][m] (m = sx*24 + c*8 + x, k = pair*64 + y + 8z; 48 KiB),
// then each of 128 threads takes one point: it builds its column of the
// separable weights wy(y)*wz(z) in registers, contracts it with lhs in fp32
// (48 accumulators, 16-byte broadcast reads of lhs), and applies wx.  The
// product is dense: 2*48*256 = 24,576 flops a point where K2 gathers at most
// 8 corners (~110 flops), so at level 6 on 2^18 points it needs 6.4 GFLOP,
// at least 0.096 ms on the fp32 cores (67 TFLOP/s) against K2's ~0.004 ms
// bound: bound by operations, by design.
//
// Instantiations (template <kDeep, kConstRows, kTiles>):
//   inwin_dense_deep        <true,  false, 1>  one K=256 accumulation;
//   inwin_dense_const_rows  <false, true,  1>  windows 0 and 1 staged once,
//                           every pair's product reads them;
//   inwin_dense_four_tiles  <false, false, 4>  4 products of K=64, each
//                           summed apart and added to the result (the
//                           TPU's m = m + dot(...)), 4 tiles a block in turn.
// Tolerance against the plain version: atol 1e-5 (fp32 sums in another
// order; the weights multiply the table values in another association).
#include <cuda_runtime.h>
#include <cstdint>

#include "inwin_dense.cuh"
#include "level_params.cuh"

namespace {

using n2m::axis_w;
using n2m::kDenseK;
using n2m::kDensePairK;
using n2m::kDenseRows;
using n2m::kTile;

// acc[m] += lhs[k][m] * w for the 48 rows m, lhs row k as 12 16-byte loads
// (every lane reads the same address: a broadcast).
__device__ __forceinline__ void axpy48(const float* __restrict__ lhs_k, float w,
                                       float (&acc)[kDenseRows]) {
  const float4* r = reinterpret_cast<const float4*>(lhs_k);
#pragma unroll
  for (int i = 0; i < kDenseRows / 4; ++i) {
    const float4 a = r[i];
    acc[4 * i] = fmaf(a.x, w, acc[4 * i]);
    acc[4 * i + 1] = fmaf(a.y, w, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a.z, w, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a.w, w, acc[4 * i + 3]);
  }
}

// acc += lhs[k0 .. k0+64) x the pair (sy, sz)'s weights of one point.
__device__ __forceinline__ void pair_product(const float* __restrict__ lhs,
                                             int k0, int sy, int sz,
                                             const int lg[3], const float fr[3],
                                             float (&acc)[kDenseRows]) {
  for (int z = 0; z < 8; ++z) {
    const float wz = axis_w(z + 8 * sz, lg[2], fr[2]);
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const float w = __fmul_rn(axis_w(y + 8 * sy, lg[1], fr[1]), wz);
      axpy48(lhs + (k0 + y + 8 * z) * kDenseRows, w, acc);
    }
  }
}

// Block b takes tiles b*kTiles ... in turn; thread p = threadIdx.x takes
// point p of each.  bases [n_tiles, 3], rows [n_tiles, 8] of the level;
// dynamic shared memory: lhs, [kDenseK or 64][48] floats.
template <bool kDeep, bool kConstRows, int kTiles>
__global__ void __launch_bounds__(kTile)
inwin_dense_kernel(const float* __restrict__ table, const float* __restrict__ x,
                   const int32_t* __restrict__ bases,
                   const int32_t* __restrict__ rows, float scale, float shift,
                   int64_t off, int64_t n_tiles, float* __restrict__ out) {
  extern __shared__ float4 lhs4[];
  float* lhs = reinterpret_cast<float*>(lhs4);
  if (kConstRows) {             // windows 0 and 1 as the one pair's operand
    n2m::stage_window(table, off, 0, 0, 0, kDenseRows, lhs);
    n2m::stage_window(table, off, 1, 1, 0, kDenseRows, lhs);
  }
  for (int j = 0; j < kTiles; ++j) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kTiles + j;
    if (t >= n_tiles) break;                             // block-uniform
    if (!kConstRows) {
      if (j > 0) __syncthreads();                        // lhs of tile t-1 read
      for (int s = 0; s < 8; ++s)                        // pair q = 2*sy + sz
        n2m::stage_window(table, off, rows[t * 8 + s], s & 1,
                          (2 * ((s >> 1) & 1) + (s >> 2)) * kDensePairK,
                          kDenseRows, lhs);
    }
    __syncthreads();
    const int64_t p = t * kTile + threadIdx.x;
    int lg[3];
    float fr[3];
    n2m::dense_lattice(x, p, bases + t * 3, scale, shift, lg, fr);
    float m[kDenseRows];
#pragma unroll
    for (int i = 0; i < kDenseRows; ++i) m[i] = 0.f;
    for (int q = 0; q < 4; ++q) {
      const int k0 = kConstRows ? 0 : q * kDensePairK;
      if (kDeep) {
        pair_product(lhs, k0, q >> 1, q & 1, lg, fr, m);
      } else {
        float part[kDenseRows];
#pragma unroll
        for (int i = 0; i < kDenseRows; ++i) part[i] = 0.f;
        pair_product(lhs, k0, q >> 1, q & 1, lg, fr, part);
#pragma unroll
        for (int i = 0; i < kDenseRows; ++i) m[i] += part[i];
      }
    }
    n2m::dense_epilogue([&](int r) { return m[r]; }, lg, fr, out + p * 3);
  }
}

template <bool kDeep, bool kConstRows, int kTiles>
cudaError_t launch(const float* table, const float* x, const int32_t* bases,
                   const int32_t* rows, float scale, float shift, int64_t off,
                   int64_t n_tiles, float* out, cudaStream_t stream) {
  const int smem = (kConstRows ? kDensePairK : kDenseK) * kDenseRows * 4;
  const unsigned blocks = static_cast<unsigned>((n_tiles + kTiles - 1) / kTiles);
  inwin_dense_kernel<kDeep, kConstRows, kTiles><<<blocks, kTile, smem, stream>>>(
      table, x, bases, rows, scale, shift, off, n_tiles, out);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 deep, 1 const_rows, 2 four_tiles.  table: [total, 3] f32;
// x: [n_points, 3] f32 clipped to [0, 1], n_points = 128 * n_tiles; bases:
// [n_tiles, 3] i32 and rows: [n_tiles, 8] i32 of the level (tile_meta;
// const_rows reads no rows); scale, offset: the level's lattice scale and
// first table row; out: [n_points, 3] f32.
extern "C" int n2m_inwin_dense(int variant, const void* table, const void* x,
                               const void* bases, const void* rows,
                               float scale, int32_t offset, float shift,
                               int64_t n_points, int64_t n_tiles, void* out,
                               void* stream) {
  if (n_points != n_tiles * kTile || offset % 512 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const auto* tab = static_cast<const float*>(table);
  const auto* xp = static_cast<const float*>(x);
  const auto* b = static_cast<const int32_t*>(bases);
  const auto* r = static_cast<const int32_t*>(rows);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return static_cast<int>(launch<true, false, 1>(
        tab, xp, b, r, scale, shift, offset, n_tiles, o, s));
    case 1: return static_cast<int>(launch<false, true, 1>(
        tab, xp, b, r, scale, shift, offset, n_tiles, o, s));
    case 2: return static_cast<int>(launch<false, false, 4>(
        tab, xp, b, r, scale, shift, offset, n_tiles, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
