// K7 inwin_dense: K2's in-window features [N, 1, 3] at one level, computed
// as the TPU computes them, by the dense window contraction, on Hopper's
// tensor cores (wgmma) with a 3xTF32 split.
//
// Replaces: workspace/ab/microbench_kernel_variants.py `_kern_b` (:64, one
// deep [48,256] x [256,128] product a tile), `_kern_c` (:109, the
// constant-row probe: every slot pair reads windows 0 and 1) and `_kern_d`
// (:149, the 4-product form with 4 tiles a grid step): the TPU's timing
// variants of K2's MXU formulation (`_fwd_kernel`, splat_encode.py:234-256).
// No path of the system runs them; chip_smoke.py times them beside K2.
//
// What a tile does: the product D [128 points x 48] = A [128 x 256] x
// B [256 x 48], then out[p][c] = sum over x, sx of D[p][sx*24 + c*8 + x] *
// wx(x + 8 sx).  B is the tile's 8 slot windows (inwin_dense.cuh's layout);
// A holds each point's separable weights wy(y + 8 sy) * wz(z + 8 sz).  The
// product is dense: 2*48*256 = 24,576 flops a point where K2 gathers 8
// corners (~110 flops), 6.4 GFLOP at level 6 on 2^18 points, so it is bound
// by operations.  As one fp32-exact product on the fp32 cores that is
// 0.096 ms at 67 TFLOP/s; as three tf32 products on the tensor cores
// (495 TFLOP/s) 0.039 ms.  Design:
//   - A block is two consumer warpgroups (points 0-63 and 64-127 of a tile,
//     one m64n48 accumulator each) and one producer warpgroup.
//   - The producer stages B: it reads each window's 1,536 contiguous floats
//     with 16-byte loads, splits every value into tf32 hi + lo, and writes
//     both into the swizzled K-major layout wgmma reads (96 KiB a tile).  A
//     ring of stages and two mbarriers a stage (full, empty) let it stage
//     tile t+1 while the consumers' wgmmas run on tile t.
//   - A consumer builds its A fragments in registers (never in memory), 2
//     k-steps at a time: wy*wz at its two points, split into tf32 hi + lo.
//     Each k-step is 3 wgmma.m64n48k8, A_lo*B_hi + A_hi*B_lo + A_hi*B_hi
//     into fp32 (dropping A_lo*B_lo: ~2^-22 of each term); one commit group
//     runs while the next group's A is built, and the next tile's points
//     are read while this tile runs.
//   - Epilogue: a thread holds 12 of the 48 columns of its two points; wx
//     weights them, two quad shuffles sum the quad, and each warp writes its
//     16 points' 48 floats as 12 16-byte stores.
// On an H100 the tf32 pipe alone would take ~0.042 ms (wgmma.m64n48k8
// sustains 440-480 TFLOP/s); building A, staging B and each tile's first
// and last group (both warpgroups wait for the same stage) add the rest.
//
// Instantiations (template V):
//   inwin_dense_deep        0  one accumulator over K = 256; a persistent
//                              block walks tiles, B double-buffered;
//   inwin_dense_const_rows  1  windows 0 and 1 staged once a block (K = 64),
//                              every pair's product reads them, each summed
//                              apart; a persistent block walks tiles;
//   inwin_dense_four_tiles  2  4 products of K = 64 a tile, each summed
//                              apart and added to the result (the TPU's
//                              m = m + dot(...)), 4 tiles a block, B
//                              double-buffered.
// Tolerance against the plain version: atol 1e-5 (the split keeps ~22
// bits; fp32 sums in another order).
#include <cuda_runtime.h>
#include <cstdint>

#include "inwin_dense.cuh"
#include "level_params.cuh"

namespace {

using n2m::axis_w;
using n2m::kDenseK;
using n2m::kDensePairK;
using n2m::kKBlock;
using n2m::kPairBytes;
using n2m::kSwAtom;
using n2m::kTile;

constexpr int kConsumers = 2 * 128;          // two warpgroups: m64 halves
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
constexpr int kGroupK = 2;                   // k-steps a commit group
constexpr int kGroups = kDenseK / 8 / kGroupK;   // groups a tile
constexpr int kPairGroups = kDensePairK / 8 / kGroupK;

template <int V>
struct Traits {
  static constexpr bool kApart = V != 0;     // each pair's product apart
  static constexpr bool kConst = V == 1;     // windows 0, 1 staged once
  static constexpr int kStages = kConst ? 1 : 2;
  static constexpr int kPerBlock = V == 2 ? 4 : 0;  // tiles; 0: persistent
  static constexpr int kOperand = (kConst ? kDensePairK : kDenseK) / 32 *
                                  kKBlock;   // bytes of B_hi, and of B_lo
  static constexpr int kStage = 2 * kOperand;
  static constexpr int kSmem = kStages * kStage + 1024;  // + 1 KiB to align
};

// The producer's share of one window: floats 4*(p + 128 i) + u, i < 3,
// u < 4, at byte offsets eo[4i + u] of slot (sx 0, pair 0).
__device__ __forceinline__ void stage_window(const float* __restrict__ src,
                                             const uint32_t (&eo)[12], int p,
                                             uint8_t* hi, int lo_off) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 v = __ldg(s4 + p + 128 * i);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t h, l;
      n2m::split_tf32(f[u], h, l);
      *reinterpret_cast<uint32_t*>(hi + eo[4 * i + u]) = h;
      *reinterpret_cast<uint32_t*>(hi + lo_off + eo[4 * i + u]) = l;
    }
  }
}

// A of group gr (k-steps z0 .. z0 + kGroupK - 1 of slot pair q = 2sy + sz)
// at the thread's rows: a0/a2 (point 0) and a1/a3 (point 1) at columns
// y + 8z, y = tq and tq + 4, z the k-step, weight wy(y + 8sy) * wz(z + 8sz),
// split into tf32 hi + lo.
__device__ __forceinline__ void build_a(int gr, int tq, const int (&lg)[2][3],
                                        const float (&fr)[2][3],
                                        uint32_t (&ahi)[kGroupK][4],
                                        uint32_t (&alo)[kGroupK][4]) {
  const int q = gr / kPairGroups, sy = q >> 1, sz = q & 1;
  const int z0 = kGroupK * (gr % kPairGroups);
  float wy[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      wy[h][e] = axis_w(tq + 4 * e + 8 * sy, lg[h][1], fr[h][1]);
#pragma unroll
  for (int i = 0; i < kGroupK; ++i) {
    const float wz0 = axis_w(z0 + i + 8 * sz, lg[0][2], fr[0][2]);
    const float wz1 = axis_w(z0 + i + 8 * sz, lg[1][2], fr[1][2]);
    n2m::split_tf32(__fmul_rn(wy[0][0], wz0), ahi[i][0], alo[i][0]);
    n2m::split_tf32(__fmul_rn(wy[1][0], wz1), ahi[i][1], alo[i][1]);
    n2m::split_tf32(__fmul_rn(wy[0][1], wz0), ahi[i][2], alo[i][2]);
    n2m::split_tf32(__fmul_rn(wy[1][1], wz1), ahi[i][3], alo[i][3]);
  }
}

// The 3 * kGroupK wgmmas of group gr into d: a k-step's A_lo*B_hi +
// A_hi*B_lo + A_hi*B_hi.  The first k-step of the tile (of the pair, when
// apart) overwrites d.
template <int V>
__device__ __forceinline__ void issue_group(float (&d)[24], int gr,
                                            uint32_t b_hi,
                                            const uint32_t (&ahi)[kGroupK][4],
                                            const uint32_t (&alo)[kGroupK][4]) {
  using Tr = Traits<V>;
  const int q = gr / kPairGroups, z0 = kGroupK * (gr % kPairGroups);
#pragma unroll
  for (int i = 0; i < kGroupK; ++i) {
    const int k0 = (Tr::kConst ? 0 : q * kDensePairK) + 8 * (z0 + i);
    const uint64_t dh = n2m::b_desc(b_hi + (k0 >> 5) * kKBlock + (k0 & 31) * 4);
    const uint64_t dl = dh + (Tr::kOperand >> 4);       // B_lo
    const bool first = i == 0 && (Tr::kApart ? z0 == 0 : gr == 0);
    n2m::wgmma_m64n48k8(d, alo[i], dh, first ? 0u : 1u);
    n2m::wgmma_m64n48k8(d, ahi[i], dl, 1u);
    n2m::wgmma_m64n48k8(d, ahi[i], dh, 1u);
  }
}

// m = part (the first pair) or m + part: the TPU's m = m + dot(...).
__device__ __forceinline__ void add_pair(float (&m)[24], float (&part)[24],
                                         bool first) {
  n2m::fence_operand(part);
#pragma unroll
  for (int i = 0; i < 24; ++i) m[i] = first ? part[i] : m[i] + part[i];
}

// Block b takes tiles first + j*step, j < count (kPerBlock tiles from
// b*kPerBlock, or b, b + gridDim.x, ...).  bases [n_tiles, 3], rows
// [n_tiles, 8] of the level.
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
inwin_dense_kernel(const float* __restrict__ table, const float* __restrict__ x,
                   const int32_t* __restrict__ bases,
                   const int32_t* __restrict__ rows, float scale, float shift,
                   int64_t off, int64_t n_tiles, float* __restrict__ out) {
  using Tr = Traits<V>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[Tr::kStages], empty[Tr::kStages];
  __shared__ __align__(16) float res[kConsumers / 32][48];  // 16 points x 3
  // the swizzle repeats every 1024 bytes: stages start on such a boundary
  uint8_t* buf = smem_raw + ((1024 - (n2m::smem_addr(smem_raw) & 1023)) & 1023);

  int64_t first, step, count;
  if constexpr (Tr::kPerBlock > 0) {
    first = static_cast<int64_t>(blockIdx.x) * Tr::kPerBlock;
    step = 1;
    count = n_tiles - first < Tr::kPerBlock ? n_tiles - first : Tr::kPerBlock;
  } else {
    first = blockIdx.x;
    step = gridDim.x;
    count = (n_tiles - first + step - 1) / step;
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < Tr::kStages; ++s) {
      n2m::mbar_init(n2m::smem_addr(&full[s]), 128);
      n2m::mbar_init(n2m::smem_addr(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warpgroup
    // an apart variant's consumers hold two pair accumulators more: without
    // registers from the producer (88 * 128 + 208 * 256 = 168 * 384) ptxas
    // spills them
    if constexpr (Tr::kApart)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 88;" ::: "memory");
    const int p = tid - kConsumers;
    uint32_t eo[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int f = 4 * (p + 128 * (i >> 2)) + (i & 3);
      const int cell = f / 3, c = f - 3 * cell;
      eo[i] = n2m::b_offset(c * 8 + (cell & 7), ((cell >> 3) & 7) + 8 * (cell >> 6));
    }
    const int64_t n_stage = Tr::kConst ? 1 : count;
    for (int64_t j = 0; j < n_stage; ++j) {
      const int s = static_cast<int>(j % Tr::kStages);
      if (j >= Tr::kStages)
        n2m::mbar_wait(n2m::smem_addr(&empty[s]),
                       static_cast<uint32_t>((j / Tr::kStages - 1) & 1));
      const int64_t t = first + j * step;
      uint8_t* hi = buf + s * Tr::kStage;
#pragma unroll
      for (int w = 0; w < (Tr::kConst ? 2 : 8); ++w) {  // slot w = sx + 2sy + 4sz
        const int32_t win = Tr::kConst ? w : __ldg(rows + t * 8 + w);
        const int q = Tr::kConst ? 0 : 2 * ((w >> 1) & 1) + (w >> 2);
        stage_window(table + (off + static_cast<int64_t>(win) * 512) * 3, eo,
                     p, hi + q * kPairBytes + (w & 1) * 3 * kSwAtom,
                     Tr::kOperand);
      }
      // the stores above are read by wgmma, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      n2m::mbar_arrive(n2m::smem_addr(&full[s]));
    }
    return;
  }

  if constexpr (Tr::kApart)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;" ::: "memory");
  // consumers: thread (warpgroup h, warp w, lane 4g + tq) holds tile rows
  // r0 = 64h + 16w + g and r0 + 8
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = 64 * (tid >> 7) + 16 * warp + g;
  float* rw = res[tid >> 5];
  float m[24], part[2][24];
#pragma unroll
  for (int i = 0; i < 24; ++i) m[i] = part[0][i] = part[1][i] = 0.f;
  if (Tr::kConst) n2m::mbar_wait(n2m::smem_addr(&full[0]), 0);
  // the points of the next tile are read while this one runs
  float xs[2][3];
  int32_t bs[3];
  n2m::load_points(x, bases, first, r0, xs, bs);
  for (int64_t j = 0; j < count; ++j) {
    const int64_t t = first + j * step;
    const int s = Tr::kConst ? 0 : static_cast<int>(j % Tr::kStages);
    int lg[2][3];
    float fr[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      n2m::dense_lattice(xs[h], bs, scale, shift, lg[h], fr[h]);
    if (j + 1 < count) n2m::load_points(x, bases, t + step, r0, xs, bs);
    if (!Tr::kConst)
      n2m::mbar_wait(n2m::smem_addr(&full[s]),
                     static_cast<uint32_t>((j / Tr::kStages) & 1));
    const uint32_t b_hi = n2m::smem_addr(buf + s * Tr::kStage);
    // kGroups groups of kGroupK k-steps, one in flight while the next one's
    // A is built; an apart pair's product goes to part[q & 1] and is added
    // to m once its last group is done
    uint32_t ahi[2][kGroupK][4], alo[2][kGroupK][4];
    build_a(0, tq, lg, fr, ahi[0], alo[0]);
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr) {
      float (&d)[24] = Tr::kApart ? part[(gr / kPairGroups) & 1] : m;
      n2m::fence_operand(d);
      n2m::wgmma_fence();
      issue_group<V>(d, gr, b_hi, ahi[gr & 1], alo[gr & 1]);
      n2m::wgmma_commit();
      n2m::wgmma_wait<1>();                    // the groups before gr are done
      if (Tr::kApart && gr >= kPairGroups && gr % kPairGroups == 0)
        add_pair(m, part[(gr / kPairGroups - 1) & 1], gr == kPairGroups);
      if (gr + 1 < kGroups)
        build_a(gr + 1, tq, lg, fr, ahi[(gr + 1) & 1], alo[(gr + 1) & 1]);
    }
    n2m::wgmma_wait<0>();
    n2m::fence_operand(m);
    if (Tr::kApart) add_pair(m, part[1], false);
    if (!Tr::kConst && j + Tr::kStages < count)   // the stage may be refilled
      n2m::mbar_arrive(n2m::smem_addr(&empty[s]));

    // out[p][c] = sum over sx, x of D[p][sx*24 + c*8 + x] * wx(x + 8 sx):
    // this thread holds x = 2tq, 2tq + 1 (d[4(3 sx + c) + 2h + v])
    float o[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float a = 0.f;
#pragma unroll
        for (int sx = 0; sx < 2; ++sx)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            a += m[4 * (3 * sx + c) + 2 * h + v] *
                 axis_w(2 * tq + v + 8 * sx, lg[h][0], fr[h][0]);
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        o[h][c] = a;
      }
    if (tq < 3) {
      rw[g * 3 + tq] = tq == 0 ? o[0][0] : (tq == 1 ? o[0][1] : o[0][2]);
      rw[(g + 8) * 3 + tq] = tq == 0 ? o[1][0] : (tq == 1 ? o[1][1] : o[1][2]);
    }
    __syncwarp();
    if (lane < 12)
      reinterpret_cast<float4*>(out + (t * kTile + r0 - g) * 3)[lane] =
          reinterpret_cast<const float4*>(rw)[lane];
    __syncwarp();                              // rw is rewritten next tile
  }
}

template <int V>
cudaError_t launch(const float* table, const float* x, const int32_t* bases,
                   const int32_t* rows, float scale, float shift, int64_t off,
                   int64_t n_tiles, float* out, cudaStream_t stream) {
  using Tr = Traits<V>;
  cudaError_t e = cudaFuncSetAttribute(
      inwin_dense_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tr::kSmem);
  if (e != cudaSuccess) return e;
  int64_t blocks;
  if constexpr (Tr::kPerBlock > 0) {
    blocks = (n_tiles + Tr::kPerBlock - 1) / Tr::kPerBlock;
  } else {                                     // one persistent block an SM
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    blocks = n_tiles < sms ? n_tiles : sms;
  }
  inwin_dense_kernel<V><<<static_cast<unsigned>(blocks), kThreads, Tr::kSmem,
                          stream>>>(table, x, bases, rows, scale, shift, off,
                                    n_tiles, out);
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
    case 0: return static_cast<int>(launch<0>(tab, xp, b, r, scale, shift,
                                              offset, n_tiles, o, s));
    case 1: return static_cast<int>(launch<1>(tab, xp, b, r, scale, shift,
                                              offset, n_tiles, o, s));
    case 2: return static_cast<int>(launch<2>(tab, xp, b, r, scale, shift,
                                              offset, n_tiles, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
