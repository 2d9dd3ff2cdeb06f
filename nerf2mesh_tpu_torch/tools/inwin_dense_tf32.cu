// A tensor-core build of K7b (csrc/inwin_dense.cu, inwin_dense_deep): the
// same [48, 256] x [256, 128] product a tile, on the tensor cores as TF32
// with fp32 accumulation (mma.sync.m16n8k8).  Not part of the package: built
// and timed by tools/ab_inwin.py beside K7b and K2, to measure whether
// tensor cores would carry K2's window products.  TF32 keeps 10 bits of
// mantissa, so on a table in [-1, 1] it is expected ~1e-3 from the plain
// version, not within K2's 1e-5; the script logs its error.
//
// A tile a block of 4 warps: the 8 slot windows are staged as lhs[k][m]
// (row stride 56 floats, so that a warp's A-fragment loads hit 32 banks),
// each warp takes 32 points (4 n8 tiles) x all 48 rows (3 m16 tiles) over
// 32 k8 steps, building its B fragments (the weights wy*wz) in registers;
// the product goes through shared memory to the per-point x contraction.
//
// Built with nvcc -I nerf2mesh_tpu_torch/csrc; C interface for ctypes.
#include <cuda_runtime.h>
#include <cstdint>

#include "inwin_dense.cuh"
#include "level_params.cuh"

namespace {

using n2m::axis_w;
using n2m::kDenseK;
using n2m::kTile;

constexpr int kLd = 56;                  // lhs row stride (floats)
constexpr int kMLd = kTile + 1;          // product row stride (floats)
constexpr int kSmem = kDenseK * kLd * 4; // 56 KiB; the product reuses it

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kTile)
inwin_dense_tf32_kernel(const float* __restrict__ table,
                        const float* __restrict__ x,
                        const int32_t* __restrict__ bases,
                        const int32_t* __restrict__ rows, float scale,
                        float shift, int64_t off, float* __restrict__ out) {
  extern __shared__ float4 sm4[];
  float* lhs = reinterpret_cast<float*>(sm4);
  __shared__ int s_lg[3][kTile];
  __shared__ float s_fr[3][kTile];
  const int64_t t = blockIdx.x;
  for (int s = 0; s < 8; ++s)
    n2m::stage_window(table, off, rows[t * 8 + s], s & 1,
                      (2 * ((s >> 1) & 1) + (s >> 2)) * 64, kLd, lhs);
  const int64_t p = t * kTile + threadIdx.x;
  int lg[3];
  float fr[3];
  n2m::dense_lattice(x, p, bases + t * 3, scale, shift, lg, fr);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    s_lg[d][threadIdx.x] = lg[d];
    s_fr[d][threadIdx.x] = fr[d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  float acc[3][4][4] = {};
  for (int s = 0; s < kDenseK / 8; ++s) {
    const int q = s >> 3, z = s & 7, sy = q >> 1, sz = q & 1, kb = 8 * s;
    uint32_t a[3][4];
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      const int m = 16 * mt + g;
      a[mt][0] = tf32(lhs[(kb + tg) * kLd + m]);
      a[mt][1] = tf32(lhs[(kb + tg) * kLd + m + 8]);
      a[mt][2] = tf32(lhs[(kb + tg + 4) * kLd + m]);
      a[mt][3] = tf32(lhs[(kb + tg + 4) * kLd + m + 8]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 32 * warp + 8 * nt + g;
      const float wz = axis_w(z + 8 * sz, s_lg[2][n], s_fr[2][n]);
      const uint32_t b0 = tf32(axis_w(tg + 8 * sy, s_lg[1][n], s_fr[1][n]) * wz);
      const uint32_t b1 = tf32(axis_w(tg + 4 + 8 * sy, s_lg[1][n], s_fr[1][n]) * wz);
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
    }
  }
  __syncthreads();                         // lhs read: reuse it as M[48][129]
  float* M = lhs;
#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = 16 * mt + g, c = 32 * warp + 8 * nt + 2 * tg;
      M[r * kMLd + c] = acc[mt][nt][0];
      M[r * kMLd + c + 1] = acc[mt][nt][1];
      M[(r + 8) * kMLd + c] = acc[mt][nt][2];
      M[(r + 8) * kMLd + c + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  n2m::dense_epilogue([&](int r) { return M[r * kMLd + threadIdx.x]; }, lg, fr,
                      out + p * 3);
}

}  // namespace

// As n2m_inwin_dense (csrc/inwin_dense.cu) with the deep product on the
// tensor cores.
extern "C" int n2m_inwin_dense_tf32(const void* table, const void* x,
                                    const void* bases, const void* rows,
                                    float scale, int32_t offset, float shift,
                                    int64_t n_points, int64_t n_tiles,
                                    void* out, void* stream) {
  if (n_points != n_tiles * kTile || offset % 512 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = cudaFuncSetAttribute(
      inwin_dense_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  inwin_dense_tf32_kernel<<<static_cast<unsigned>(n_tiles), kTile, kSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(rows),
      scale, shift, offset, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
