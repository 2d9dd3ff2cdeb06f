// Attribution builds of K2 inwin_fwd and K1 occ_lookup, timed by
// inwin_fwd_attribution.py (beside this file).  Not part of the package:
// every build with a MODE bit of 1 or 2 is wrong on purpose.
//
// K2, the body before its redesign (one thread a (point, level), levels
// innermost), MODE bits:
//   1 (a) no output stores (a never-true guard keeps the work alive),
//   2 (b) constant rows: slot s reads window s & 1, the gather form of K7c,
//   4 (c) level-major lanes: a warp takes 32 consecutive points at one
//         level (stores still direct, 12 bytes at a stride of 12 * Lk).
// K2, the redesign (the package's body: a block a tile, its results staged
// in shared memory and stored as 16-byte vectors), MODE bit 8, with 1 and
// 2 as above.
// K1: the body before its redesign (one thread an index), and that body
// and the redesign's (a 16-byte vector a lane a step) with the word gather
// replaced by the index's own low bit.
//
// Built with nvcc -I nerf2mesh_tpu_torch/csrc; C interface for ctypes.
#include <cuda_runtime.h>
#include <cstdint>

#include "level_params.cuh"

namespace {

using n2m::kTile;
using n2m::LevelParams;
using n2m::pack_levels;

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

template <int MODE>
__device__ __forceinline__ void sum_corners(const float* __restrict__ table,
                                            const int lg[3], const float fr[3],
                                            int64_t off, const int32_t* r,
                                            float& a0, float& a1, float& a2) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int slot, cell;
    float w;
    if (!inwin_corner(lg, fr, c, slot, cell, w)) continue;
    const int32_t win = (MODE & 2) ? (slot & 1) : r[slot];
    const float* v = table + (off + static_cast<int64_t>(win) * 512 + cell) * 3;
    a0 = __fadd_rn(a0, __fmul_rn(w, __ldg(v)));
    a1 = __fadd_rn(a1, __fmul_rn(w, __ldg(v + 1)));
    a2 = __fadd_rn(a2, __fmul_rn(w, __ldg(v + 2)));
  }
}

template <int MODE>
__global__ void old_kernel(const float* __restrict__ table,
                           const float* __restrict__ x,
                           const int32_t* __restrict__ bases,
                           const int32_t* __restrict__ rows,
                           const __grid_constant__ LevelParams lp, float shift,
                           int64_t n_points, int64_t n_tiles, int n_levels,
                           float* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_points * n_levels) return;
  int64_t p;
  int k;
  if (MODE & 4) {
    const int64_t w = tid >> 5, g = w / n_levels;
    k = static_cast<int>(w - g * n_levels);
    p = g * 32 + (tid & 31);
  } else {
    p = tid / n_levels;
    k = static_cast<int>(tid - p * n_levels);
  }
  const int64_t tk = static_cast<int64_t>(k) * n_tiles + p / kTile;
  const int32_t bp[3] = {bases[tk * 3], bases[tk * 3 + 1], bases[tk * 3 + 2]};
  const float xp[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  int lg[3];
  float fr[3];
  lattice_at(xp, bp, lp.scale[k], shift, lg, fr);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  sum_corners<MODE>(table, lg, fr, lp.offset[k], rows + tk * 8, a0, a1, a2);
  const int64_t o = (p * n_levels + k) * 3;
  if (MODE & 1) {
    if (a0 == 1234.5f && a1 == 1.5f) out[o] = a2;   // never true on the inputs
    return;
  }
  out[o] = a0;
  out[o + 1] = a1;
  out[o + 2] = a2;
}

template <int MODE>
__global__ void __launch_bounds__(256)
staged_kernel(const float* __restrict__ table, const float* __restrict__ x,
              const int32_t* __restrict__ bases,
              const int32_t* __restrict__ rows,
              const __grid_constant__ LevelParams lp, float shift,
              int64_t n_tiles, int n_levels, float* __restrict__ out) {
  extern __shared__ float s_out[];
  __shared__ int4 s_x4[kTile * 3 / 4];
  __shared__ int32_t s_base[n2m::kMaxLevels * 3];
  __shared__ int32_t s_rows[n2m::kMaxLevels * 8];
  const int64_t t = blockIdx.x;
  const int l3 = 3 * n_levels;
  const int stride = l3 | 1;
  if (threadIdx.x < kTile * 3 / 4)
    s_x4[threadIdx.x] = reinterpret_cast<const int4*>(x)[t * (kTile * 3 / 4) +
                                                         threadIdx.x];
  for (int i = threadIdx.x; i < l3; i += blockDim.x)
    s_base[i] = bases[((i / 3) * n_tiles + t) * 3 + i % 3];
  for (int i = threadIdx.x; i < 8 * n_levels; i += blockDim.x)
    s_rows[i] = rows[((i >> 3) * n_tiles + t) * 8 + (i & 7)];
  __syncthreads();
  const float* xs = reinterpret_cast<const float*>(s_x4);
  const int lane = threadIdx.x & 31;
  for (int it = threadIdx.x >> 5; it < n_levels * 4; it += blockDim.x >> 5) {
    const int k = it / 4;
    const int p = (it % 4) * 32 + lane;
    const float xp[3] = {xs[p * 3], xs[p * 3 + 1], xs[p * 3 + 2]};
    const int32_t bp[3] = {s_base[k * 3], s_base[k * 3 + 1], s_base[k * 3 + 2]};
    int lg[3];
    float fr[3];
    lattice_at(xp, bp, lp.scale[k], shift, lg, fr);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    sum_corners<MODE>(table, lg, fr, lp.offset[k], s_rows + 8 * k, a0, a1, a2);
    float* o = s_out + p * stride + 3 * k;
    o[0] = a0;
    o[1] = a1;
    o[2] = a2;
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + t * kTile * l3);
  for (int e4 = threadIdx.x; e4 < kTile * l3 / 4; e4 += blockDim.x) {
    int p = 4 * e4 / l3, r = 4 * e4 - p * l3;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = s_out[p * stride + r];
      if (++r == l3) r = 0, ++p;
    }
    if (MODE & 1) {
      if (v[0] == 1234.5f && v[1] == 1.5f) dst[e4].x = v[2];
    } else {
      dst[e4] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

struct Args {
  const float* table;
  const float* x;
  const int32_t* bases;
  const int32_t* rows;
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
      a.table, a.x, a.bases, a.rows, a.lp, a.shift, a.n_points, a.n_tiles,
      a.n_levels, a.out);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_staged(const Args& a) {
  const int smem = kTile * ((3 * a.n_levels) | 1) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        staged_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  staged_kernel<M><<<static_cast<unsigned>(a.n_tiles), 256, smem, a.stream>>>(
      a.table, a.x, a.bases, a.rows, a.lp, a.shift, a.n_tiles, a.n_levels,
      a.out);
  return cudaGetLastError();
}

struct Variant {
  const char* name;
  cudaError_t (*launch)(const Args&);
  int exact;       // 1: must match the plain version; 0: wrong on purpose
};

#define OLD(M, NAME) {NAME, launch_old<M>, ((M) & 3) == 0}
#define STAGED(M, NAME) {NAME, launch_staged<M>, ((M) & 3) == 0}

const Variant kVariants[] = {
    OLD(0, "d_current"),
    OLD(1, "a_no_stores"),
    OLD(2, "b_const_rows"),
    OLD(4, "c_level_major"),
    OLD(3, "ab_no_stores_const_rows"),
    STAGED(8, "s_staged"),
    STAGED(8 | 1, "s_staged_no_stores"),
    STAGED(8 | 2, "s_staged_const_rows"),
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

template <bool kWords>
__global__ void occ_old_kernel(const int32_t* __restrict__ words,
                               const int32_t* __restrict__ idx,
                               int32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t c = idx[i];
  const uint32_t w = kWords ? static_cast<uint32_t>(__ldg(words + (c >> 5)))
                            : static_cast<uint32_t>(c);
  out[i] = static_cast<int32_t>((w >> (kWords ? (c & 31) : 0)) & 1u);
}

// The redesign's body (occ_lookup.cu) on aligned idx and out, the bit
// being the index's own low bit: no word is read.
__global__ void __launch_bounds__(256)
occ_vec_no_words_kernel(const int4* __restrict__ iv, int4* __restrict__ ov,
                        int64_t n_vec) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * 256;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
       v < n_vec; v += step) {
    const int4 c = iv[v];
    ov[v] = make_int4(c.x & 1, c.y & 1, c.z & 1, c.w & 1);
  }
}

}  // namespace

extern "C" int k2v_count() { return kNumVariants; }
extern "C" const char* k2v_name(int v) { return kVariants[v].name; }
extern "C" int k2v_exact(int v) { return kVariants[v].exact; }

extern "C" int k2v_launch(int v, const void* table, const void* x,
                          const void* bases, const void* rows,
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
  a.bases = static_cast<const int32_t*>(bases);
  a.rows = static_cast<const int32_t*>(rows);
  a.shift = shift;
  a.n_points = n_points;
  a.n_tiles = n_tiles;
  a.n_levels = n_levels;
  a.out = static_cast<float*>(out);
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kVariants[v].launch(a));
}

// v: 0 the old body, 1 the old body without word reads, 2 the redesign's
// body without word reads (idx and out 16-byte aligned, n a multiple of 4).
extern "C" int k1v_launch(int v, const void* words, const void* idx, void* out,
                          int64_t n, int sms, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int32_t*>(words);
  if (v == 0 || v == 1) {
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    if (v == 0)
      occ_old_kernel<true><<<blocks, 256, 0, s>>>(
          w, static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), n);
    else
      occ_old_kernel<false><<<blocks, 256, 0, s>>>(
          w, static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), n);
  } else if (v == 2) {
    if (n % 4 || reinterpret_cast<uintptr_t>(idx) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t want = (n / 4 + 255) / 256, cap = 8LL * sms;
    occ_vec_no_words_kernel<<<static_cast<unsigned>(want < cap ? want : cap),
                              256, 0, s>>>(static_cast<const int4*>(idx),
                                           static_cast<int4*>(out), n / 4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
