#!/bin/bash
# nerf-synthetic suite, NeuS-SDF mode, on the port (the reference's
# runall_syn_sdf.sh).  Data parallel: LAUNCH="torchrun --nproc_per_node N".
set -e
DATA_ROOT=${DATA_ROOT:-data/nerf_synthetic}
LAUNCH=${LAUNCH:-python}
for scene in lego chair drums ficus hotdog materials mic ship; do
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --sdf \
    --workspace "trial_syn_sdf_$scene" --bound 1 --scale 0.8 --dt_gamma 0 --stage 0
  $LAUNCH -m nerf2mesh_tpu_torch.main "$DATA_ROOT/$scene" -O --sdf \
    --workspace "trial_syn_sdf_$scene" --bound 1 --scale 0.8 --dt_gamma 0 --stage 1
done
