// K4 sweep_fwd: the full multiresolution hash encode of the "ref" table
// layout for small tables (2^log2_hashmap_size <= 2^14), linear
// interpolation: x01 [N, 3] -> features [N, L*C], zero for points outside
// [0, 1]^3.
//
// Replaces: nerf2mesh_tpu/ops/pallas_encode.py `_kernel` (via _fwd_pallas /
// sweep_encode).  On the TPU the whole table sits in VMEM as a padded
// channel-major [L*C, S] copy and each 128-point tile sweeps every 1024-entry
// block of it with lane gathers, because XLA's random gathers were scalar
// loops there.
//
// Indices (those of hashgrid._corner_indices for the ref layout): a dense
// level reads row ix + iy*side + iz*side^2 (side = resolution + 1; side^3
// never exceeds the level's size on a hash grid, so the modulo by the size
// is taken only on a tiled grid, where it can); a hashed level
// reads (ix*1 ^ iy*2654435761 ^ iz*805459861) & (size - 1) in uint32, which
// wraps for free.  Rows are read from the canonical ragged [total, C] table
// at offset_l + index; the TPU's padded copy was a VMEM layout only.
//
// Bound on the H100: bytes.  Per (point, level) the kernel reads 12 B of
// position (shared by the point's L threads), does ~76 flops and 8 corner
// reads of 12 B, and writes 12 B.  The table (2.84 MiB at the 16-level,
// 2^14, C=3 configuration) stays resident in the 50 MB L2, so the corner
// reads are L2 hits; the [N, L*C] output (50 MB at 2^18 points) is the
// traffic to device memory that bounds the kernel.
//
// Design: one thread per (point, level), threads ordered point-major, so a
// warp writes 32 consecutive (point, level) outputs as one coalesced run.
// The per-level constants are a device array of 16 B records, read once
// per thread through the read-only cache, so any number of levels fits one
// launch.  No shared-memory staging: one level's slice of at most 16384
// rows * 12 B = 192 KiB would fit a block's 227 KiB, but the L2 already
// holds the whole table (later work).  The lattice position x*scale + shift
// is computed with __fmul_rn/__fadd_rn so its floor equals PyTorch's
// separately rounded multiply and add (hashgrid.lattice).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kC = 3;          // channels of the merged table

// One level: float32 lattice scale, first table row, dense corner side (0
// on hashed levels) and the level's row count (a power of two on hashed
// levels).
struct SweepLevel {
  float scale;
  int32_t offset;
  uint32_t side;
  uint32_t size;
};

__global__ void sweep_fwd_kernel(const float* __restrict__ table,
                                 const float* __restrict__ x,
                                 const SweepLevel* __restrict__ levels,
                                 float shift, int64_t n_points, int n_levels,
                                 float* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_points * n_levels) return;
  const int64_t p = tid / n_levels;
  const int l = static_cast<int>(tid - p * n_levels);
  float acc[kC] = {0.f, 0.f, 0.f};

  const float xs[3] = {x[p * 3], x[p * 3 + 1], x[p * 3 + 2]};
  const bool oob = xs[0] < 0.f || xs[0] > 1.f || xs[1] < 0.f || xs[1] > 1.f ||
                   xs[2] < 0.f || xs[2] > 1.f;
  if (!oob) {
    const SweepLevel lv = levels[l];
    uint32_t g[3];
    float fr[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pos = __fadd_rn(__fmul_rn(xs[d], lv.scale), shift);
      const float fl = floorf(pos);
      fr[d] = __fsub_rn(pos, fl);
      g[d] = static_cast<uint32_t>(fl);
    }
    const float* base = table + static_cast<int64_t>(lv.offset) * kC;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t bx = k & 1, by = (k >> 1) & 1, bz = (k >> 2) & 1;
      const uint32_t cx = g[0] + bx, cy = g[1] + by, cz = g[2] + bz;
      uint32_t idx;
      if (lv.side == 0) {
        idx = ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) &
              (lv.size - 1u);
      } else {
        idx = cx + cy * lv.side + cz * lv.side * lv.side;
        if (idx >= lv.size) idx %= lv.size;   // only a tiled grid wraps
      }
      const float wx = bx ? fr[0] : __fsub_rn(1.0f, fr[0]);
      const float wy = by ? fr[1] : __fsub_rn(1.0f, fr[1]);
      const float wz = bz ? fr[2] : __fsub_rn(1.0f, fr[2]);
      const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
      const float* row = base + static_cast<int64_t>(idx) * kC;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(w, __ldg(row + c)));
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) out[tid * kC + c] = acc[c];
}

}  // namespace

// table: [total, 3] f32 canonical ref layout; x: [n_points, 3] f32 (any
// values; points outside [0,1]^3 give zeros); levels: DEVICE array
// [n_levels] of {f32 lattice scale, i32 first table row, u32 dense corner
// side or 0 on a hashed level, u32 row count}, n_levels >= 1; out:
// [n_points, n_levels, 3] f32.
extern "C" int n2m_sweep_fwd(const void* table, const void* x,
                             const void* levels, float shift,
                             int64_t n_points, int n_levels, void* out,
                             void* stream) {
  if (n_levels < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = n_points * n_levels;
  if (n > 0) {
    const int threads = 256;
    sweep_fwd_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                       threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(x),
        static_cast<const SweepLevel*>(levels), shift, n_points, n_levels,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
