#!/bin/bash
# Mip-NeRF-360 unbounded scenes on the port (the reference's runall_360*.sh:
# indoor bound 8 scale 0.3, outdoor bound 16 scale 0.2, cam-center and
# near/far, entropy and TV regularization, downscale 4).  Data parallel:
# LAUNCH="torchrun --nproc_per_node N".
set -e
DATA_ROOT=${DATA_ROOT:-data/360_v2}
LAUNCH=${LAUNCH:-python}
for scene in room counter kitchen bonsai; do
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --data_format colmap \
    --workspace "trial_360_$scene" --bound 8 --scale 0.3 --downscale 4 \
    --enable_cam_center --enable_cam_near_far \
    --lambda_entropy 1e-3 --lambda_tv 2e-8 --stage 0
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --data_format colmap \
    --workspace "trial_360_$scene" --bound 8 --scale 0.3 --downscale 4 \
    --enable_cam_center --enable_cam_near_far \
    --lambda_entropy 1e-3 --lambda_tv 2e-8 --stage 1 --iters 10000
done
for scene in garden bicycle stump; do
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --data_format colmap \
    --workspace "trial_360_$scene" --bound 16 --scale 0.2 --downscale 4 \
    --enable_cam_center --enable_cam_near_far \
    --lambda_entropy 1e-3 --lambda_tv 2e-8 --stage 0
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --data_format colmap \
    --workspace "trial_360_$scene" --bound 16 --scale 0.2 --downscale 4 \
    --enable_cam_center --enable_cam_near_far \
    --lambda_entropy 1e-3 --lambda_tv 2e-8 --stage 1 --iters 10000
done
