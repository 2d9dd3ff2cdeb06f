"""Two-stage run on the hard proxy scene (textures, thin rods, speculars;
data/synthetic.py HardScene) at 256^2 (the port's counterpart of
scripts/capstone_hard_run.py): the -O-equivalent recipe, reporting stage-0
and stage-1 PSNR/SSIM/LPIPS (proxy) and exporting the web package.

    python -m nerf2mesh_tpu_torch.scripts.capstone_hard_run [scene dir] [workspace]

Generates the scene (48 train, 3 val and 3 test views) when the directory
holds none.  Runs on the card.
"""

import os
import sys
import time

STAGE0_ARGS = [
    "--bound", "1", "--scale", "0.8", "--dt_gamma", "0",
    "--iters", "4000", "--num_rays", "4096", "--num_points", "262144",
    "--grid_size", "128", "--diffuse_step", "1000",
    "--random_image_batch", "--mark_untrained", "--adaptive_num_rays",
    "--mesh_visibility_culling",
    "--mcubes_reso", "256", "--decimate_target", "100000",
    "--n_eval", "2", "--n_ckpt", "2", "--test_no_video"]
STAGE1_ARGS = [
    "--stage", "1", "--bound", "1", "--scale", "0.8", "--dt_gamma", "0",
    "--iters", "1500", "--refine", "--texture_size", "1024", "--ssaa", "1",
    "--n_eval", "2", "--n_ckpt", "2", "--test_no_video"]


def run(root: str, workspace: str) -> None:
    from nerf2mesh_tpu_torch.data.synthetic import (HardScene,
                                                    generate_synthetic_dataset)
    from nerf2mesh_tpu_torch.main import main

    if not os.path.exists(os.path.join(root, "transforms_train.json")):
        generate_synthetic_dataset(root, scene=HardScene(), H=256, W=256,
                                   n_train=48, n_val=3, n_test=3)
    t0 = time.time()
    main([root, "--workspace", workspace] + STAGE0_ARGS)
    print(f"STAGE0 DONE {time.time() - t0:.0f}s", flush=True)
    main([root, "--workspace", workspace] + STAGE1_ARGS)
    print(f"ALL DONE {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "data/hard_scene",
        sys.argv[2] if len(sys.argv) > 2 else "trial_capstone_hard")
