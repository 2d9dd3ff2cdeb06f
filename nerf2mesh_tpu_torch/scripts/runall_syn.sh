#!/bin/bash
# nerf-synthetic suite, NeRF mode, on the port (the reference's
# runall_syn.sh hyperparameters: bound 1, scale 0.8, dt_gamma 0, two stages
# and the web export).  Data parallel: set LAUNCH="torchrun
# --nproc_per_node N" (one rank a card).
set -e
DATA_ROOT=${DATA_ROOT:-data/nerf_synthetic}
LAUNCH=${LAUNCH:-python}
for scene in lego chair drums ficus hotdog materials mic ship; do
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O \
    --workspace "trial_syn_$scene" --bound 1 --scale 0.8 --dt_gamma 0 --stage 0
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O \
    --workspace "trial_syn_$scene" --bound 1 --scale 0.8 --dt_gamma 0 --stage 1
done
