// K1 occ_lookup: bit n of the packed occupancy grid for each linear cell
// index n = ((cas*H + x)*H + y)*H + z.
//
// Replaces: nerf2mesh_tpu/ops/occ_sweep.py `_kernel` (via occ_lookup_sweep),
// the Pallas kernel that sweeps the VMEM-resident packed grid row by row so
// that the TPU never issues a serial HBM gather.
//
// Bound on the H100: memory latency.  Each lookup is one 4-byte load from a
// table of CAS*H^3/32 words (256 KB at H=128) plus a 4-byte index read and a
// 4-byte write; the table stays resident in the 50 MB L2, so the reads are
// L2 hits whose latency, not bandwidth, limits a thread.
//
// Design: one thread per index and no shared-memory staging.  The streaming
// index/output traffic is coalesced; the random word reads go through the
// read-only path (__ldg) and are hidden by running many threads per SM.
// The bit order is the JAX one: bit i of word w is cell 32*w + i, so
// pack_bits() output compares equal between the two packages.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void occ_lookup_kernel(const int32_t* __restrict__ words,
                                  const int32_t* __restrict__ idx,
                                  int32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t c = idx[i];
  const uint32_t w = static_cast<uint32_t>(__ldg(words + (c >> 5)));
  out[i] = static_cast<int32_t>((w >> (c & 31)) & 1u);
}

}  // namespace

// words: [n_words] int32; idx: [n] int32 in [0, 32*n_words) (caller clamps);
// out: [n] int32 0/1.
extern "C" int n2m_occ_lookup(const void* words, const void* idx, void* out,
                              int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    occ_lookup_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), static_cast<const int32_t*>(idx),
        static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
