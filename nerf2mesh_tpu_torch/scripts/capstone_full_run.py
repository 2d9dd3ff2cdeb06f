"""Two-stage run at a realistic scale on the 256^2 procedural sphere scene
(the port's counterpart of scripts/capstone_full_run.py): stage 0 for 3000
iterations with the culled mesh at 256^3, then stage 1 for 1000 with
refines and the 1024^2 textured export.

    python -m nerf2mesh_tpu_torch.scripts.capstone_full_run [scene dir] [workspace]

Generates the scene (24 train, 2 val and 2 test views) when the directory
holds none.  Runs on the card.
"""

import os
import sys
import time

STAGE0_ARGS = [
    "--bound", "1", "--scale", "0.8", "--dt_gamma", "0",
    "--iters", "3000", "--num_rays", "2048", "--num_points", "65536",
    "--grid_size", "128", "--diffuse_step", "500",
    "--random_image_batch", "--mark_untrained", "--adaptive_num_rays",
    "--mesh_visibility_culling",
    "--mcubes_reso", "256", "--decimate_target", "100000",
    "--n_eval", "2", "--n_ckpt", "2", "--test_no_video"]
STAGE1_ARGS = [
    "--stage", "1", "--bound", "1", "--scale", "0.8", "--dt_gamma", "0",
    "--iters", "1000", "--refine", "--texture_size", "1024", "--ssaa", "1",
    "--n_eval", "2", "--n_ckpt", "2", "--test_no_video"]


def run(root: str, workspace: str) -> None:
    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
    from nerf2mesh_tpu_torch.main import main

    if not os.path.exists(os.path.join(root, "transforms_train.json")):
        generate_synthetic_dataset(root, H=256, W=256, n_train=24, n_val=2,
                                   n_test=2)
    t0 = time.time()
    main([root, "--workspace", workspace] + STAGE0_ARGS)
    print(f"STAGE0 DONE {time.time() - t0:.0f}s", flush=True)
    main([root, "--workspace", workspace] + STAGE1_ARGS)
    print(f"ALL DONE {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "data/bench_scene",
        sys.argv[2] if len(sys.argv) > 2 else "trial_capstone_full")
