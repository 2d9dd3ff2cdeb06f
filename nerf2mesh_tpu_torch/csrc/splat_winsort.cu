// K5 winsort_fwd and K6 winsort_bwd: the in-block part of trilinear block512
// hash-grid interpolation on window-sorted fine levels, and its table
// gradient.
//
// Replaces: nerf2mesh_tpu/ops/splat_encode.py `_ws_fwd_kernel` (via
// _ws_level_fwd / _inwin_ws) and `_ws_bwd_kernel` (via _ws_level_bwd).  On
// the TPU those contract one VMEM-resident [24, 64] window per slot against
// the separable weights of a 128-point tile, masked by each point's window
// id, on the MXU; the backward's sequential grid reads, modifies and writes
// the slot's window in VMEM, one [24, 64] product per slot.
//
// Contract (that of splat_encode_raw's winsort branch): per winsort level,
// the points are sorted by the window id of their own 8^3 block (`perm`,
// `wins`); tile t of the sorted order has two slots, its first and last
// point's window clamped to >= 0 (`slots`).  A point whose window equals one
// of its tile's slots sums its in-block corners: those whose local lattice
// coordinate (g & 7) + bit stays <= 7 on every axis, read from the canonical
// [total, C] table (C = 1, 2 or 3) at offsets[l] + win*512 + lx + 8*ly +
// 64*lz.  Every other
// corner, and every corner of a point outside the slots (oob points have
// window -1 and never match), adds 0 here and is left to the residual that
// splat_encode_raw computes in PyTorch.  The result is written at the
// point's position in the caller's order, out[perm[i], k].  The lattice
// position is __fadd_rn(__fmul_rn(x, s), shift), as in K2: PyTorch decides
// which corners cross the block edge with a separately rounded multiply and
// add, and one floor that differed would count a corner twice or drop it.
//
// Both kernels are templates on C with one instantiation for each of C = 1,
// 2 and 3; the numbers below are C = 3's (a row is 4C bytes).
//
// K5, bound on the H100: its scattered output.  Per (point, level) it reads
// the point's sort metadata (coalesced), 12 B of position at a scattered
// index, up to 8 corners of 12 B from one 6 KiB window, and writes 12 B at a
// random row of out.  A thread a (level, sorted point) that reads the
// corners through L1 (~20 lines a warp load) and writes three 4-byte stores
// spends two thirds of its time on the stores: their partial sectors of out
// compete in L2 with the streamed windows and metadata.
// So one block owns a chunk of kWsFwdTiles tiles of one level's sorted order:
// `wins[k]` ascends there (the -1 tail last), so the chunk's slots name at
// most 2 * kWsFwdTiles distinct windows, the clamped tail slot 0 among them.
// Warp 0 dedupes the slots; the block stages those windows in shared memory
// as 16-byte rows (4-byte cp.async, so a corner is one conflict-light
// 16-byte shared load; at C = 1 and 2 rows of 4 and 8 bytes, packed), then
// each thread sums its points' in-block corners from there and writes each
// result as one 8-byte and one 4-byte store (C = 1: one 4-byte store; C =
// 2: one 8-byte store).  The
// windows and the metadata are read once, with an L2 evict_first policy, so
// they do not push out's partial sectors from L2.  out is written with
// inline-asm stores: the same stores written in C++ ran ~16% slower on the
// H100, and an L2 evict_last policy on them made K5 ~5% faster inside the
// encode but the kernels after it slower by more (PERF.md).  The grid is
// (chunks, levels), sized by the points and not by the windows: no run
// search, no fixed cost a window.
// K6, bound on the H100: the gradient's bytes, once the adds stay on chip.
// With 2^18 points and 1024 windows a level, ~256 points add into each
// window's 512 rows; one device-memory float atomic per (point, corner,
// channel) serialised the lanes of a warp on one window.  Instead each
// window has one owner block and no global atomic is made.  Ownership:
// `wins[k]` ascends (the -1 tail sorts last), so a window id's points form
// one run; a run that spans several tiles is the first or last window of
// each of them, so all its points are slotted, and a run strictly inside one
// tile has none slotted.  So every in-block corner of level k that lands in
// window w comes from w's run.  Block (w, k) finds the run by binary search
// (the -1 tail as +inf), walks it with the same membership test, reads x and
// grad through perm, adds into a 2C KiB shared [512, C] window with shared
// atomics, and writes the window with coalesced 16-byte stores (zeros when
// none of the run is slotted).  A window id with no run is not written: it
// keeps the zeros of the caller's buffer.  A long run is a loop in its block.
// Shared float atomics are compare-and-swap loops: clustered points, whose
// runs are long and whose lanes share lattice cells, made the block's adds
// into one row serialise and retry (slower than the device-memory atomics
// they replaced).  So in a run of 8 or more blockfuls, or in a warp in which
// two neighbouring lanes share a cell, the lanes of each cell sum each
// corner's terms with shuffles first (peer_sum) and add once a cell; other
// warps (the uniform case) add directly, paying one shuffle and one vote a
// point for the test.  The run
// is found by a block-wide search (block_run), not one thread's binary
// search: every block searches, and most own no run when points cluster.
#include <cuda_runtime.h>
#include <cstdint>

#include "level_params.cuh"
#include "warp_peers.cuh"

namespace {

using n2m::kTile;
using n2m::LevelParams;
using n2m::pack_levels;
using n2m::peer_sum;

constexpr int kWsBwdThreads = 256;

// Is sorted point i of winsort level k, of window win, in one of its tile's
// two slots?
__device__ __forceinline__ bool in_slots(const int32_t* __restrict__ slots,
                                         int64_t n_tiles, int k, int64_t i,
                                         int32_t win) {
  const int32_t* s = slots + (static_cast<int64_t>(k) * n_tiles + i / kTile) * 2;
  return win == s[0] || win == s[1];
}

// Lattice cell of point p at winsort level k: lg its coordinate in its own
// 8^3 block, fr the fractions.
__device__ __forceinline__ void block_lattice(const float* __restrict__ x,
                                              const LevelParams& lp, float shift,
                                              int64_t p, int k, int lg[3],
                                              float fr[3]) {
  const float sc = lp.scale[k];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[p * 3 + d], sc), shift);
    const float g = floorf(pos);
    fr[d] = __fsub_rn(pos, g);
    lg[d] = static_cast<int>(g) & 7;
  }
}

// Corner c of the cell (bit d = offset along axis d): false if it crosses
// the block's edge; else its row `cell` = lx + 8*ly + 64*lz in the point's
// window and its weight w.
__device__ __forceinline__ bool inblock_corner(const int lg[3], const float fr[3],
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

constexpr int kWsFwdTiles = 4;                    // tiles a K5 block
constexpr int kWsFwdThreads = 256;
constexpr int kWsFwdWindows = 2 * kWsFwdTiles;    // at most 2 distinct a tile

// A staged row of a [total, C] window: C floats, padded to 4 at C = 3, so
// that a corner is one 4-, 8- or 16-byte shared load.
template <int C>
struct StagedRow {
  static constexpr int kFloats = C == 3 ? 4 : C;
  static constexpr int kSmem = kWsFwdWindows * 512 * kFloats * 4;  // 16, 32, 64 KiB
};

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int32_t load_hinted(const int32_t* p, uint64_t pol) {
  int32_t v;
  asm volatile("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// out[o..o+C-1] = a: at C = 3 one 8-byte and one 4-byte store (o is a float
// index; the 8-byte half goes where it is aligned), at C = 2 one 8-byte
// store (o is even), at C = 1 one 4-byte store.
template <int C>
__device__ __forceinline__ void store_row(float* out, int64_t o, const float (&a)[C]) {
  if constexpr (C == 1) {
    asm volatile("st.global.f32 [%0], %1;" ::"l"(out + o), "f"(a[0]) : "memory");
  } else if constexpr (C == 2) {
    asm volatile("st.global.v2.f32 [%0], {%1, %2};"
                 ::"l"(out + o), "f"(a[0]), "f"(a[1]) : "memory");
  } else if ((o & 1) == 0) {
    asm volatile("st.global.v2.f32 [%0], {%1, %2};"
                 ::"l"(out + o), "f"(a[0]), "f"(a[1]) : "memory");
    asm volatile("st.global.f32 [%0], %1;" ::"l"(out + o + 2), "f"(a[2]) : "memory");
  } else {
    asm volatile("st.global.f32 [%0], %1;" ::"l"(out + o), "f"(a[0]) : "memory");
    asm volatile("st.global.v2.f32 [%0], {%1, %2};"
                 ::"l"(out + o + 1), "f"(a[1]), "f"(a[2]) : "memory");
  }
}

// Row `row` of a staged window (rows of StagedRow<C>::kFloats floats) into v.
template <int C>
__device__ __forceinline__ void load_row(const float* wsm, int row, float (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = wsm[row];
  } else if constexpr (C == 2) {
    const float2 t = reinterpret_cast<const float2*>(wsm)[row];
    v[0] = t.x;
    v[1] = t.y;
  } else {
    const float4 t = reinterpret_cast<const float4*>(wsm)[row];
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
  }
}

// Block (c, k) = (blockIdx.x, blockIdx.y): tiles [c * kWsFwdTiles, ...) of
// winsort level k.
template <int C>
__global__ void __launch_bounds__(kWsFwdThreads)
winsort_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ wins,
                   const int32_t* __restrict__ slots,
                   const __grid_constant__ LevelParams lp, float shift,
                   int64_t n_points, int64_t n_tiles, int n_levels,
                   float* __restrict__ out) {
  constexpr int kRow = StagedRow<C>::kFloats;
  constexpr int kWinFloats = 512 * C;              // one window of the table
  extern __shared__ float4 win4[];                 // [n_win][512] rows
  __shared__ int32_t s_win[kWsFwdWindows];         // the distinct slot windows
  __shared__ int32_t s_idx[kWsFwdWindows];         // (tile, slot) -> staged
  __shared__ int s_n;
  const uint64_t stream_pol = l2_evict_first();
  const int k = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kWsFwdTiles;
  const int nt = static_cast<int>(min(static_cast<int64_t>(kWsFwdTiles), n_tiles - t0));
  if (threadIdx.x < 32) {
    // lane j holds slot j of the chunk (tile j / 2); it is first if no lower
    // lane holds the same window, and its staged index is the count of
    // first lanes below the lowest lane that holds it
    const int j = threadIdx.x;
    const bool valid = j < 2 * nt;
    const int32_t v =
        valid ? slots[(static_cast<int64_t>(k) * n_tiles + t0) * 2 + j] : -1;
    int src = j;
#pragma unroll
    for (int q = kWsFwdWindows - 1; q >= 0; --q) {
      const int32_t vq = __shfl_sync(0xffffffffu, v, q);
      if (q < j && vq == v) src = q;
    }
    const unsigned first = __ballot_sync(0xffffffffu, valid && src == j);
    if (valid) {
      const int rank = __popc(first & ((1u << src) - 1u));
      s_idx[j] = rank;
      if (src == j) s_win[rank] = v;
    }
    if (j == 0) s_n = __popc(first);
  }
  __syncthreads();
  float* wsm = reinterpret_cast<float*>(win4);
  const int64_t off = lp.offset[k];
  for (int e = threadIdx.x; e < s_n * kWinFloats; e += kWsFwdThreads) {
    const int u = e / kWinFloats, r = (e % kWinFloats) / C, ch = e % C;
    const float* src =
        table + (off + static_cast<int64_t>(s_win[u]) * 512 + r) * C + ch;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(wsm + (u * 512 + r) * kRow + ch));
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "l"(stream_pol));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int64_t kn = static_cast<int64_t>(k) * n_points;
  for (int j = threadIdx.x; j < nt * kTile; j += kWsFwdThreads) {
    const int64_t i = t0 * kTile + j;
    const int32_t win = load_hinted(wins + kn + i, stream_pol);
    const int64_t p = load_hinted(perm + kn + i, stream_pol);
    const int u0 = s_idx[2 * (j / kTile)], u1 = s_idx[2 * (j / kTile) + 1];
    const int u = win == s_win[u0] ? u0 : (win == s_win[u1] ? u1 : -1);
    float a[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) a[ch] = 0.f;
    if (u >= 0) {
      int lg[3];
      float fr[3];
      block_lattice(x, lp, shift, p, k, lg, fr);
      const float* rows = wsm + u * 512 * kRow;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int cell;
        float w;
        if (!inblock_corner(lg, fr, c, cell, w)) continue;
        float t[C];
        load_row<C>(rows, cell, t);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) a[ch] = __fadd_rn(a[ch], __fmul_rn(w, t[ch]));
      }
    }
    store_row<C>(out, (p * n_levels + k) * C, a);
  }
}

// [lo, hi) of window w's run in wk[0, n) (ascending, the -1 tail last: as
// uint32 it is the largest key), by a block-wide 256-ary search for both
// ends.  Each round every thread tests the last entry of its 1/256th of the
// interval and __syncthreads_count says how many lie below the target, so
// 2^18 entries take 3 rounds of one load where a binary search took 18
// dependent loads (most blocks of a small or clustered input own no run,
// and the search was most of their time).  Every thread must call it.
__device__ __forceinline__ void block_run(const int32_t* __restrict__ wk,
                                          int64_t n, int32_t w, int64_t& lo_out,
                                          int64_t& hi_out) {
  int64_t lo[2] = {0, 0}, hi[2] = {n, n};
  const uint32_t target[2] = {static_cast<uint32_t>(w),
                              static_cast<uint32_t>(w) + 1u};
  while (hi[0] > lo[0] || hi[1] > lo[1]) {              // block-uniform
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t step = (hi[e] - lo[e] + blockDim.x - 1) / blockDim.x;
      const int64_t j = lo[e] + (threadIdx.x + 1) * step - 1;
      const bool below = hi[e] > lo[e] && j < hi[e] &&
                         static_cast<uint32_t>(wk[j]) < target[e];
      const int c = __syncthreads_count(below);   // a prefix of the threads
      if (hi[e] > lo[e]) {
        const int64_t last = lo[e] + (c + 1) * step - 1;
        lo[e] += c * step;
        hi[e] = hi[e] < last ? hi[e] : last;
      }
    }
  }
  lo_out = lo[0];
  hi_out = lo[1];
}

// Block (w, k) = (blockIdx.x, blockIdx.y) owns window w of winsort level k.
template <int C>
__global__ void __launch_bounds__(kWsBwdThreads)
winsort_bwd_kernel(const float* __restrict__ grad, const float* __restrict__ x,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ wins,
                   const int32_t* __restrict__ slots,
                   const __grid_constant__ LevelParams lp, float shift,
                   int64_t n_points, int64_t n_tiles, int n_levels,
                   float* __restrict__ dtable) {
  constexpr int kWinFloats = 512 * C;              // one window of the table
  __shared__ float4 acc4[kWinFloats / 4];
  float* acc = reinterpret_cast<float*>(acc4);
  const int k = blockIdx.y;
  const int32_t w = static_cast<int32_t>(blockIdx.x);
  const int64_t kn = static_cast<int64_t>(k) * n_points;
  int64_t lo, hi;
  block_run(wins + kn, n_points, w, lo, hi);
  if (lo == hi) return;                  // no point of this window
  for (int c = threadIdx.x; c < kWinFloats / 4; c += blockDim.x)
    acc4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // a run of 8 or more blockfuls (~8x the points of a window at 2^18
  // uniform points) is a cluster: sum over the lanes of a cell always
  const bool crowded = hi - lo >= 8 * static_cast<int64_t>(blockDim.x);
  for (int64_t i0 = lo; i0 < hi; i0 += blockDim.x) {     // block-uniform
    const int64_t i = i0 + threadIdx.x;
    float g[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) g[ch] = 0.f;
    int lg[3] = {0, 0, 0};
    float fr[3] = {0.f, 0.f, 0.f};
    bool live = i < hi && in_slots(slots, n_tiles, k, i, w);
    if (live) {
      const int64_t p = perm[kn + i];
      const float* gp = grad + (p * n_levels + k) * C;
      live = false;                                    // e.g. oob points
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        g[ch] = gp[ch];
        live |= g[ch] != 0.f;
      }
      if (live) block_lattice(x, lp, shift, p, k, lg, fr);
    }
    // Lanes whose points share a lattice cell add into the same 8 rows.  A
    // long run, or a neighbour lane in the same cell, is the cheap test for
    // clustered points; then the lanes of each cell sum their terms first.
    const int key = live ? lg[0] + 8 * lg[1] + 64 * lg[2] : -1 - lane;
    if (crowded ||
        __any_sync(0xffffffffu, __shfl_xor_sync(0xffffffffu, key, 1) == key)) {
      const unsigned peers = __match_any_sync(0xffffffffu, key);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int cell = 0;
        float wt = 0.f;
        const bool in = live && inblock_corner(lg, fr, c, cell, wt);
        float v[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) v[ch] = in ? __fmul_rn(g[ch], wt) : 0.f;
        if (!(peer_sum(peers, v) && in)) continue;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) atomicAdd(acc + cell * C + ch, v[ch]);
      }
    } else if (live) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int cell;
        float wt;
        if (!inblock_corner(lg, fr, c, cell, wt)) continue;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) atomicAdd(acc + cell * C + ch, __fmul_rn(g[ch], wt));
      }
    }
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(
      dtable + (lp.offset[k] + static_cast<int64_t>(w) * 512) * C);
  for (int c = threadIdx.x; c < kWinFloats / 4; c += blockDim.x) dst[c] = acc4[c];
}

}  // namespace

namespace {

template <int C>
cudaError_t launch_winsort_fwd(const void* table, const void* x, const void* perm,
                               const void* wins, const void* slots,
                               const LevelParams& lp, float shift, int64_t n_points,
                               int64_t n_tiles, int n_levels, void* out,
                               cudaStream_t stream) {
  constexpr int smem = StagedRow<C>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      winsort_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t chunks = (n_tiles + kWsFwdTiles - 1) / kWsFwdTiles;
  winsort_fwd_kernel<C><<<dim3(static_cast<unsigned>(chunks), n_levels),
                          kWsFwdThreads, smem, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(wins),
      static_cast<const int32_t*>(slots), lp, shift, n_points, n_tiles,
      n_levels, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_winsort_bwd(const void* grad, const void* x, const void* perm,
                               const void* wins, const void* slots,
                               const LevelParams& lp, float shift, int64_t n_points,
                               int64_t n_tiles, int n_levels, int64_t n_windows,
                               void* dtable, cudaStream_t stream) {
  winsort_bwd_kernel<C><<<dim3(static_cast<unsigned>(n_windows), n_levels),
                          kWsBwdThreads, 0, stream>>>(
      static_cast<const float*>(grad), static_cast<const float*>(x),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(wins),
      static_cast<const int32_t*>(slots), lp, shift, n_points, n_tiles,
      n_levels, static_cast<float*>(dtable));
  return cudaGetLastError();
}

}  // namespace

// table: [total, channels] f32, channels 1, 2 or 3; x: [n_points, 3] f32
// clipped to [0,1], any order, n_points = 128 * n_tiles; perm: [n_levels,
// n_points] i32, per level the window-sorted order (a permutation of
// 0..n_points-1); wins: [n_levels, n_points] i32 window id of each sorted
// point (-1 out of bounds); slots: [n_levels, n_tiles, 2] i32 (>= 0);
// scales, offsets: HOST arrays [n_levels] (f32 lattice scale, i32 first
// table row of the level), 1 <= n_levels <= 32; out: [n_points, n_levels,
// channels] f32 in x's order, 8-byte aligned.
extern "C" int n2m_winsort_fwd(const void* table, const void* x,
                               const void* perm, const void* wins,
                               const void* slots, const float* scales,
                               const int32_t* offsets, float shift,
                               int64_t n_points, int64_t n_tiles, int n_levels,
                               int channels, void* out, void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels < 1 || channels > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_points > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        channels == 1 ? launch_winsort_fwd<1>(table, x, perm, wins, slots, lp, shift,
                                              n_points, n_tiles, n_levels, out, st)
        : channels == 2 ? launch_winsort_fwd<2>(table, x, perm, wins, slots, lp, shift,
                                                n_points, n_tiles, n_levels, out, st)
                        : launch_winsort_fwd<3>(table, x, perm, wins, slots, lp, shift,
                                                n_points, n_tiles, n_levels, out, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad: [n_points, n_levels, channels] f32 in x's order; dtable: [total,
// channels] f32, 16-byte aligned, zeroed by the caller (the kernel writes
// whole windows of the levels, each once); n_windows: the most windows of
// any of the levels; every offsets[k] a multiple of 4 rows.  Other arguments
// as n2m_winsort_fwd.
extern "C" int n2m_winsort_bwd(const void* grad, const void* x,
                               const void* perm, const void* wins,
                               const void* slots, const float* scales,
                               const int32_t* offsets, float shift,
                               int64_t n_points, int64_t n_tiles, int n_levels,
                               int channels, int64_t n_windows, void* dtable,
                               void* stream) {
  LevelParams lp{};
  if (!pack_levels(scales, offsets, n_levels, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dtable) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int k = 0; k < n_levels; ++k)
    if (offsets[k] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_windows < 0 || n_windows > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels < 1 || channels > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points > 0 && n_windows > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e =
        channels == 1
            ? launch_winsort_bwd<1>(grad, x, perm, wins, slots, lp, shift, n_points,
                                    n_tiles, n_levels, n_windows, dtable, st)
        : channels == 2
            ? launch_winsort_bwd<2>(grad, x, perm, wins, slots, lp, shift, n_points,
                                    n_tiles, n_levels, n_windows, dtable, st)
            : launch_winsort_bwd<3>(grad, x, perm, wins, slots, lp, shift, n_points,
                                    n_tiles, n_levels, n_windows, dtable, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
