// Shared by K7's kernels (inwin_dense.cu) and the tensor-core build of its
// deep product (tools/inwin_dense_tf32.cu): the dense window contraction of
// the TPU's K2 (`_fwd_kernel`, splat_encode.py:234-256), as [M=48, K] x
// [K, 128] products a 128-point tile.  Row m = sx*24 + c*8 + x of the left
// operand is channel c at x-offset x of the slot window with x-bit sx;
// column j = y + 8z of a slot pair (sy, sz) is the window cell (x, y, z).
#pragma once

#include <cstdint>

#include "level_params.cuh"

namespace n2m {

constexpr int kDenseRows = 48;               // M: 2 slots x 3 channels x 8
constexpr int kDenseK = 256;                 // K of the deep product: 4 pairs
constexpr int kDensePairK = 64;              // K of one slot pair's product

// One-hot-ish weight of lattice row X on one axis (the TPU's `_axis_w`):
// 1 - f at the point's local floor lg, f at lg + 1, 0 elsewhere.
__device__ __forceinline__ float axis_w(int X, int lg, float f) {
  return X == lg ? __fsub_rn(1.0f, f) : (X == lg + 1 ? f : 0.0f);
}

// Stages slot window `win` of a level (first table row `off`) as the slot's
// 24 rows of the left operand lhs[k][m] (row stride `ld` floats) for the
// pair K range starting at k0: lhs[(k0 + y + 8z) * ld + sx*24 + c*8 + x] =
// table[off + win*512 + x + 8y + 64z][c].  A window's 1536 floats are
// contiguous in the table and read in order by the block's threads.
__device__ __forceinline__ void stage_window(const float* __restrict__ table,
                                             int64_t off, int32_t win, int sx,
                                             int k0, int ld, float* lhs) {
  const float* src = table + (off + static_cast<int64_t>(win) * 512) * 3;
  for (int f = threadIdx.x; f < 512 * 3; f += blockDim.x) {
    const int i = f / 3, c = f - 3 * i;
    const int x = i & 7, y = (i >> 3) & 7, z = i >> 6;
    lhs[(k0 + y + 8 * z) * ld + sx * 24 + c * 8 + x] = __ldg(src + f);
  }
}

// The tile-local lattice of point p (x [N, 3]) against its tile's base
// block b: the same separately rounded position as K2's lattice_at.
__device__ __forceinline__ void dense_lattice(const float* __restrict__ x,
                                              int64_t p, const int32_t* b,
                                              float scale, float shift,
                                              int lg[3], float fr[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[p * 3 + d], scale), shift);
    const float g = floorf(pos);
    fr[d] = __fsub_rn(pos, g);
    lg[d] = static_cast<int>(g) - 8 * b[d];
  }
}

// out[p] = sum over rows m of M[m] * wx(m): the x contraction of the
// product's column of point p, M[m] at m_of(m).
template <typename Col>
__device__ __forceinline__ void dense_epilogue(const Col& m_of, const int lg[3],
                                               const float fr[3], float* o) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x)
      a += m_of(c * 8 + x) * axis_w(x, lg[0], fr[0]) +
           m_of(24 + c * 8 + x) * axis_w(x + 8, lg[0], fr[0]);
    o[c] = a;
  }
}

}  // namespace n2m
