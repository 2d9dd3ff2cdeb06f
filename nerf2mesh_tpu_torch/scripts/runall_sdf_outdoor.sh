#!/bin/bash
# Outdoor SDF mode with dense depth supervision on the port (the
# reference's runall_sdf_* configs: --sdf, dense depth, lambda_normal 1e-1).
# Data parallel: LAUNCH="torchrun --nproc_per_node N".
set -e
DATA_ROOT=${DATA_ROOT:-data/360_v2}
LAUNCH=${LAUNCH:-python}
for scene in garden bicycle stump; do
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --sdf \
    --data_format colmap --workspace "trial_sdf_$scene" \
    --bound 16 --scale 0.2 --downscale 4 \
    --enable_cam_center --enable_cam_near_far --enable_dense_depth \
    --lambda_entropy 1e-3 --lambda_normal 1e-1 --stage 0
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --sdf \
    --data_format colmap --workspace "trial_sdf_$scene" \
    --bound 16 --scale 0.2 --downscale 4 \
    --enable_cam_center --enable_cam_near_far --enable_dense_depth \
    --lambda_entropy 1e-3 --lambda_normal 1e-1 --stage 1 --iters 10000
done
