#!/bin/bash
# LLFF forward-facing colmap captures on the port (the reference's
# runall_llff.sh: bound 4, downscale 4, colmap format, no cam-center).
# Data parallel: LAUNCH="torchrun --nproc_per_node N".
set -e
DATA_ROOT=${DATA_ROOT:-data/nerf_llff_data}
LAUNCH=${LAUNCH:-python}
for scene in fern flower fortress horns leaves orchids room trex; do
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --data_format colmap \
    --workspace "trial_llff_$scene" --bound 4 --downscale 4 \
    --enable_cam_near_far --stage 0
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --data_format colmap \
    --workspace "trial_llff_$scene" --bound 4 --downscale 4 \
    --enable_cam_near_far --stage 1 --iters 10000
done
