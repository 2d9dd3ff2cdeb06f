// Attribution builds of K5 winsort_fwd's body before its redesign (one
// thread per (level, sorted point)), timed by winsort_fwd_attribution.py
// (beside this file).  Not part of the package: every build but "d_current"
// is wrong on purpose.  MODE bits:
//   1 (a) no output stores (a never-true guard keeps the work alive),
//   2 (b) x read at the sorted index (p = i) instead of perm[i],
//   4 (c) corner c read from row c of the window, so that every lane of a
//         warp reads one address (the constant-row probe).
//
// Built with nvcc -I nerf2mesh_tpu_torch/csrc; C interface for ctypes.
#include <cuda_runtime.h>
#include <cstdint>

#include "level_params.cuh"

namespace {

using n2m::kTile;
using n2m::LevelParams;
using n2m::pack_levels;

__device__ __forceinline__ void lattice3(float x0, float x1, float x2,
                                         float sc, float shift, int lg[3],
                                         float fr[3]) {
  const float xs[3] = {x0, x1, x2};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xs[d], sc), shift);
    const float g = floorf(pos);
    fr[d] = __fsub_rn(pos, g);
    lg[d] = static_cast<int>(g) & 7;
  }
}

__device__ __forceinline__ bool corner(const int lg[3], const float fr[3],
                                       int c, int& cell, float& w) {
  const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
  const int lx = lg[0] + bx, ly = lg[1] + by, lz = lg[2] + bz;
  if (lx > 7 || ly > 7 || lz > 7) return false;
  const float wx = bx ? fr[0] : __fsub_rn(1.0f, fr[0]);
  const float wy = by ? fr[1] : __fsub_rn(1.0f, fr[1]);
  const float wz = bz ? fr[2] : __fsub_rn(1.0f, fr[2]);
  w = __fmul_rn(__fmul_rn(wx, wy), wz);
  cell = lx + 8 * ly + 64 * lz;
  return true;
}

template <int MODE>
__global__ void old_kernel(const float* __restrict__ table,
                           const float* __restrict__ x,
                           const int32_t* __restrict__ perm,
                           const int32_t* __restrict__ wins,
                           const int32_t* __restrict__ slots,
                           const __grid_constant__ LevelParams lp, float shift,
                           int64_t n_points, int64_t n_tiles, int n_levels,
                           float* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_points * n_levels) return;
  const int k = static_cast<int>(tid / n_points);
  const int64_t i = tid - static_cast<int64_t>(k) * n_points;
  const int32_t win = wins[tid];
  const int64_t p = perm[tid];
  const int64_t px = (MODE & 2) ? i : p;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const int32_t* s = slots + (static_cast<int64_t>(k) * n_tiles + i / kTile) * 2;
  if (win == s[0] || win == s[1]) {
    const float* tw = table + (lp.offset[k] + static_cast<int64_t>(win) * 512) * 3;
    int lg[3];
    float fr[3];
    lattice3(x[px * 3], x[px * 3 + 1], x[px * 3 + 2], lp.scale[k], shift, lg, fr);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int cell;
      float w;
      if (!corner(lg, fr, c, cell, w)) continue;
      if (MODE & 4) cell = c;
      a0 = __fadd_rn(a0, __fmul_rn(w, __ldg(tw + cell * 3)));
      a1 = __fadd_rn(a1, __fmul_rn(w, __ldg(tw + cell * 3 + 1)));
      a2 = __fadd_rn(a2, __fmul_rn(w, __ldg(tw + cell * 3 + 2)));
    }
  }
  const int64_t o = (p * n_levels + k) * 3;
  if (MODE & 1) {
    if (a0 == 1234.5f && a1 == 1.5f) out[o] = a2;   // never true on the inputs
    return;
  }
  out[o] = a0;
  out[o + 1] = a1;
  out[o + 2] = a2;
}

struct Args {
  const float* table;
  const float* x;
  const int32_t* perm;
  const int32_t* wins;
  const int32_t* slots;
  LevelParams lp;
  float shift;
  int64_t n_points, n_tiles;
  int n_levels;
  float* out;
  cudaStream_t stream;
};

template <int M>
cudaError_t launch_old(const Args& a) {
  const int64_t n = a.n_points * a.n_levels;
  old_kernel<M><<<static_cast<unsigned>((n + 255) / 256), 256, 0, a.stream>>>(
      a.table, a.x, a.perm, a.wins, a.slots, a.lp, a.shift, a.n_points,
      a.n_tiles, a.n_levels, a.out);
  return cudaGetLastError();
}

struct Variant {
  const char* name;
  cudaError_t (*launch)(const Args&);
  int exact;       // 1: must match the plain version; 0: wrong on purpose
};

#define OLD(M, NAME) {NAME, launch_old<M>, (M) == 0}

const Variant kVariants[] = {
    OLD(0, "d_current"),
    OLD(1, "a_no_stores"),
    OLD(2, "b_x_sorted"),
    OLD(4, "c_const_row"),
    OLD(7, "abc_all_three"),
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

extern "C" int wsv_count() { return kNumVariants; }
extern "C" const char* wsv_name(int v) { return kVariants[v].name; }
extern "C" int wsv_exact(int v) { return kVariants[v].exact; }

extern "C" int wsv_launch(int v, const void* table, const void* x,
                          const void* perm, const void* wins, const void* slots,
                          const float* scales, const int32_t* offsets,
                          float shift, int64_t n_points, int64_t n_tiles,
                          int n_levels, void* out, void* stream) {
  if (v < 0 || v >= kNumVariants) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  if (!pack_levels(scales, offsets, n_levels, &a.lp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return static_cast<int>(cudaGetLastError());
  a.table = static_cast<const float*>(table);
  a.x = static_cast<const float*>(x);
  a.perm = static_cast<const int32_t*>(perm);
  a.wins = static_cast<const int32_t*>(wins);
  a.slots = static_cast<const int32_t*>(slots);
  a.shift = shift;
  a.n_points = n_points;
  a.n_tiles = n_tiles;
  a.n_levels = n_levels;
  a.out = static_cast<float*>(out);
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kVariants[v].launch(a));
}
