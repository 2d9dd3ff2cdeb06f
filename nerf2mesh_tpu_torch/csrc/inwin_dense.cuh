// K7's operand layout and the Hopper instructions its kernel (inwin_dense.cu)
// is built from: the dense window contraction of the TPU's K2
// (`_fwd_kernel`, splat_encode.py:234-256) as a [128 points x K] x [K x 48]
// product a tile on wgmma.  Column n = sx*24 + c*8 + x of B is channel c at
// x-offset x of the slot window with x-bit sx; row k = 64q + y + 8z of a
// slot pair q = 2sy + sz is the window cell (x, y, z).
#pragma once

#include <cstdint>

#include "level_params.cuh"

namespace n2m {

constexpr int kDenseRows = 48;               // N: 2 slots x 3 channels x 8
constexpr int kDenseK = 256;                 // K of the deep product: 4 pairs
constexpr int kDensePairK = 64;              // K of one slot pair's product

// B in shared memory, K-major with the 128-byte swizzle that the wgmma
// matrix descriptor names: a row of 128 bytes holds 32 tf32 of K for one n,
// 8 rows of n make a 1024-byte atom in which 16-byte chunk j of row r sits
// at chunk j ^ r, the 6 atoms of the 48 columns follow each other (SBO =
// 1024 bytes), and each further 32 of K is one more [48 x 32] block.
constexpr int kSwRow = 128;
constexpr int kSwAtom = 8 * kSwRow;
constexpr int kKBlock = kDenseRows / 8 * kSwAtom;   // 6144 bytes
constexpr int kPairBytes = 2 * kKBlock;             // K = 64

// Byte offset of B element (n, k) from the operand's 1024-aligned start.
__host__ __device__ constexpr uint32_t b_offset(int n, int k) {
  return (k >> 5) * kKBlock + (n >> 3) * kSwAtom + (n & 7) * kSwRow +
         ((((k & 31) >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
}

// The descriptor of a K-major B operand that starts at shared address
// `addr` (a k-step 8 further along K starts 32 bytes further in the row).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |             // LBO: unused here
         (static_cast<uint64_t>(kSwAtom >> 4) << 32) |  // SBO: next 8 columns
         (static_cast<uint64_t>(1) << 62);              // 128-byte swizzle
}

// One-hot-ish weight of lattice row X on one axis (the TPU's `_axis_w`):
// 1 - f at the point's local floor lg, f at lg + 1, 0 elsewhere.
__device__ __forceinline__ float axis_w(int X, int lg, float f) {
  return X == lg ? __fsub_rn(1.0f, f) : (X == lg + 1 ? f : 0.0f);
}

// Points r0 and r0 + 8 of tile t (x [N, 3]) and the tile's base block
// (bases [T, 3]).
__device__ __forceinline__ void load_points(const float* __restrict__ x,
                                            const int32_t* __restrict__ bases,
                                            int64_t t, int r0, float (&xs)[2][3],
                                            int32_t (&b)[3]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      xs[h][d] = __ldg(x + (t * kTile + r0 + 8 * h) * 3 + d);
#pragma unroll
  for (int d = 0; d < 3; ++d) b[d] = __ldg(bases + t * 3 + d);
}

// The tile-local lattice of a point xp against its tile's base block b:
// the same separately rounded position as K2's lattice_at.
__device__ __forceinline__ void dense_lattice(const float (&xp)[3],
                                              const int32_t (&b)[3],
                                              float scale, float shift,
                                              int lg[3], float fr[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xp[d], scale), shift);
    const float g = floorf(pos);
    fr[d] = __fsub_rn(pos, g);
    lg[d] = static_cast<int>(g) - 8 * b[d];
  }
}

// v rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: the sign stands apart from the magnitude bits), in two integer
// operations: K7 ran 12% faster on an H100 so than with the conversion.
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// hi = v rounded to tf32, lo = the rest rounded so: hi + lo keeps about 22
// of v's 24 bits.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(__float_as_uint(v));
  lo = round_tf32(__float_as_uint(__fsub_rn(v, __uint_as_float(hi))));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
               :: "r"(bar) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of wgmmas are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of d across a wgmma.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A x B over one k8 step: A [64 x 8] tf32 from registers (thread
// (warp w, lane 4g + t) holds rows 16w + g, 16w + g + 8 at columns t and
// t + 4, as a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)),
// B [8 x 48] from the descriptor; d[4j + 2h + v] is row 16w + g + 8h,
// column 8j + 2t + v.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n48k8(float (&d)[24],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, uint32_t scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %29, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

}  // namespace n2m
