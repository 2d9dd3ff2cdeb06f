// Warp-level sums over lanes that add into the same shared-memory rows,
// shared by the table-gradient kernels (splat_inwin.cu, splat_winsort.cu).
// A float atomicAdd on shared memory is a compare-and-swap loop, so lanes
// of a warp that add into one address serialise and retry; summing them
// with shuffles first leaves one add a group.
#pragma once

namespace n2m {

// Sums v[0..N) over each group of peer lanes (`peers`: the lanes of the
// warp with the caller's key, from __match_any_sync, the caller included);
// the group's lowest lane ends with the sums.  The ladder of "reduce_peers":
// log2 of the group size rounds, none when every lane is alone.  Every lane
// of the warp must call it.  Returns true on the group's lowest lane.
template <int N>
__device__ __forceinline__ bool peer_sum(unsigned peers, float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  const bool first = __ffs(peers) - 1 == lane;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));   // peers below me
  peers &= ~((2u << lane) - 1u);                         // peers above me
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int src = (__ffs(peers) - 1) & 31;             // next peer above
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float t = __shfl_sync(0xffffffffu, v[j], src);
      if (peers != 0u) v[j] += t;
    }
    peers &= __ballot_sync(0xffffffffu, !(rank & 1u));   // drop finished lanes
    rank >>= 1;
  }
  return first;
}

}  // namespace n2m
