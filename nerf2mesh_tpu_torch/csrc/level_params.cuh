// Per-level constants shared by the encode kernels (splat_inwin.cu,
// splat_winsort.cu): passed by value in the launch as a __grid_constant__.
#pragma once

#include <cstdint>

namespace n2m {

constexpr int kTile = 128;   // points per tile (TILE in splat_encode.py)
constexpr int kMaxLevels = 32;

// Per kernel level: lattice scale (float32, as the JAX code rounds it) and
// the level's first row in the canonical table.
struct LevelParams {
  float scale[kMaxLevels];
  int32_t offset[kMaxLevels];
};

inline bool pack_levels(const float* scales, const int32_t* offsets,
                        int n_levels, LevelParams* lp) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  for (int k = 0; k < n_levels; ++k) {
    lp->scale[k] = scales[k];
    lp->offset[k] = offsets[k];
  }
  return true;
}

}  // namespace n2m
