// K1 occ_lookup: bit n of the packed occupancy grid for each linear cell
// index n = ((cas*H + x)*H + y)*H + z.
//
// Replaces: nerf2mesh_tpu/ops/occ_sweep.py `_kernel` (via occ_lookup_sweep),
// the Pallas kernel that sweeps the VMEM-resident packed grid row by row so
// that the TPU never issues a serial HBM gather.
//
// Bound on the H100: the word gathers.  Each lookup reads a 4-byte index,
// one 4-byte word of a table of CAS*H^3/32 words (256 KiB at H=128,
// L2-resident) and writes 4 bytes.  The 16 + 16 MiB of index and output
// streams of a 32768 x 128 call take ~0.008 ms; each word gather is a
// sector of its own in L1, about one a cycle an SM, and they take the
// rest (PERF.md, PR 7: staging the grid in a cluster pair's shared memory,
// or moving indices between lanes with shuffles, was slower).
//
// Design: a grid of up to 8 blocks of 256 threads an SM walks the indices
// as 16-byte vectors, one a thread a step, reads the four words of each
// through the read-only path (__ldg) and stores the four results as one
// 16-byte vector.  `idx` may be a view that starts off a 16-byte boundary:
// the elements before the first boundary (the head) and after the last
// whole vector (the tail), at most 3 each, take one more launch of one
// warp.  The wrapper allocates `out` at the same offset from a 16-byte
// boundary as `idx`, so the stores are vectors too; where they are not,
// each result is stored alone.  The bit order is the JAX one: bit i of
// word w is cell 32*w + i, so pack_bits() output compares equal between
// the two packages.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ int32_t bit_of(const int32_t* __restrict__ words,
                                          int32_t c) {
  return (static_cast<uint32_t>(__ldg(words + (c >> 5))) >> (c & 31)) & 1u;
}

// The vectors: iv and ov are idx and out from the first element at a
// 16-byte boundary of idx; kVec when out is at one there too (else each
// result is stored alone).  Every pointer is __restrict__, so that one
// step's index load is free to move above the last step's store.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
occ_lookup_kernel(const int32_t* __restrict__ words,
                  const int4* __restrict__ iv, int32_t* __restrict__ ov,
                  int64_t n_vec) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < n_vec; v += step) {
    const int4 c = iv[v];
    const int4 r = make_int4(bit_of(words, c.x), bit_of(words, c.y),
                             bit_of(words, c.z), bit_of(words, c.w));
    if (kVec) {
      reinterpret_cast<int4*>(ov)[v] = r;
    } else {
      ov[4 * v] = r.x;
      ov[4 * v + 1] = r.y;
      ov[4 * v + 2] = r.z;
      ov[4 * v + 3] = r.w;
    }
  }
}

// The elements before the vectors (head) and after them (tail), one a
// thread.
__global__ void occ_lookup_edges_kernel(const int32_t* __restrict__ words,
                                        const int32_t* __restrict__ idx,
                                        int32_t* __restrict__ out, int head,
                                        int64_t tail, int64_t n) {
  const int i = threadIdx.x;
  if (i < head) out[i] = bit_of(words, idx[i]);
  if (tail + i < n) out[tail + i] = bit_of(words, idx[tail + i]);
}

}  // namespace

// words: [n_words] int32; idx: [n] int32 in [0, 32*n_words) (caller clamps),
// 4-byte aligned; out: [n] int32 0/1, 4-byte aligned (16-byte stores where
// out + k is 16-byte aligned with idx + k).
extern "C" int n2m_occ_lookup(const void* words, const void* idx, void* out,
                              int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t a = reinterpret_cast<uintptr_t>(idx);
  if (a % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int head = static_cast<int>((16 - a % 16) % 16 / 4);
  if (head > n) head = static_cast<int>(n);
  const int64_t n_vec = (n - head) / 4;
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t cap = static_cast<int64_t>(dev < 64 ? sms[dev] : 132) * kBlocksPerSm;
  const auto* w = static_cast<const int32_t*>(words);
  const auto* ip = static_cast<const int32_t*>(idx);
  auto* op = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tail = head + 4 * n_vec;
  if (head > 0 || tail < n)
    occ_lookup_edges_kernel<<<1, 32, 0, s>>>(w, ip, op, head, tail, n);
  if (n_vec > 0) {
    const int64_t want = (n_vec + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
    const auto* iv = reinterpret_cast<const int4*>(ip + head);
    if (reinterpret_cast<uintptr_t>(op + head) % 16 == 0)
      occ_lookup_kernel<true><<<blocks, kThreads, 0, s>>>(w, iv, op + head, n_vec);
    else
      occ_lookup_kernel<false><<<blocks, kThreads, 0, s>>>(w, iv, op + head, n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}
