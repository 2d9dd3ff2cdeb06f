"""CLI entry point of the port (counterpart of nerf2mesh_tpu/main.py).

Usage:  python -m nerf2mesh_tpu_torch.main <data dir> [flags of config.py]

The data dir is a blender scene (transforms_{split}.json; --downscale and
the trainval/all splits resize the frames), or a COLMAP capture under
--data_format colmap (sparse/0/*.bin + images/, PNG or JPEG frames; with
--enable_sparse_depth or --enable_dense_depth, depths/*.npy, depth
supervision): then the ray box shrinks to the sparse points' box before
training, and the unbounded recipes run at --bound > 1 (cascades), with
--contract, --enable_cam_center and --enable_cam_near_far.

Runs on the first CUDA card.  Stage 0: --ckpt latest|scratch|<path> (under
--sdf, scratch first fits the SDF to a double sphere), then either --test
(test eval with PSNR, SSIM and LPIPS, the test video, and the mesh unless
--test_no_mesh) or training with validation evals, the final val and test
evals, the video, the sharpen phase (under -O or --sharpen_steps; never
under --sdf) and its checkpoint, and the mesh export to
<workspace>/mesh_stage0/mesh_0.ply (culled against the training views under
--mesh_visibility_culling).  Stage 1 (--stage 1): loads that mesh and the
checkpoint (--ckpt latest falls back to the stage-0 one), trains the vertex
offsets and the appearance through the rasterizer (refining under
--refine), evaluates, and writes <workspace>/mesh_stage1/ for renderer.html;
with --test it evaluates the loaded stage-1 state.  The command line exits
non-zero when there is no card; from Python, ``main(argv, device="cpu")``
runs on the CPU.

Not ported yet (NotImplementedError naming the ROADMAP item, raised before
any work): the dtu provider and more than one device (A7); --vis_pose (A7)
raises once the datasets are loaded, and orbax checkpoints (A6) when one
is written or read.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None, device=None):
    """Run the flow of nerf2mesh_tpu.main; returns the Trainer."""
    import torch

    from .config import parse_args
    from .utils.metrics import LPIPSMeter, PSNRMeter, SSIMMeter
    from .utils.trainer import Trainer

    cfg = parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(
                "nerf2mesh_tpu_torch.main: no CUDA device found; the port "
                "runs on the card (from Python, main(argv, device='cpu') "
                "runs it on the CPU)")
        device = "cuda:0"
    if cfg.data_format == "colmap":
        from .data.colmap import load_colmap_dataset as load_dataset
    elif cfg.data_format == "nerf":
        from .data.provider import load_nerf_dataset as load_dataset
    else:
        raise NotImplementedError(f"the {cfg.data_format} provider is not "
                                  "ported yet (ROADMAP A7)")
    if any(int(n) > 1 for n in cfg.mesh_shape):
        raise NotImplementedError(
            f"mesh_shape {cfg.mesh_shape}: multi-device training is not "
            "ported yet (ROADMAP A7); the port runs on one device")

    np.random.seed(cfg.seed)
    trainer = Trainer(cfg, device=device)

    train_ds = None
    if cfg.stage == 1:
        # the offsets must exist before the checkpoint load, or it drops a
        # stage-1 checkpoint's offsets as unexpected
        train_ds = load_dataset(cfg, split=cfg.train_split)
        trainer.setup_stage1(train_ds)

    if cfg.ckpt == "latest":
        if not trainer.load_checkpoint() and cfg.stage == 1:
            trainer.load_checkpoint(stage=0)
    elif cfg.ckpt == "scratch":
        if cfg.sdf and cfg.stage == 0:
            trainer.sdf_pretrain()
    elif cfg.ckpt:
        trainer.load_checkpoint(cfg.ckpt)

    if cfg.test:
        test_ds = load_dataset(cfg, split="test")
        if test_ds.has_gt:
            trainer.metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter()]
            trainer.evaluate(test_ds, name="test", write_images=True)
        if not cfg.test_no_video:
            trainer.test_video(test_ds)
        if not cfg.test_no_mesh and cfg.stage == 0:
            trainer.save_mesh(
                resolution=cfg.mcubes_reso,
                decimate_target=cfg.decimate_target,
                dataset=(load_dataset(cfg, split=cfg.train_split)
                         if cfg.mesh_visibility_culling else None))
        return trainer

    if train_ds is None:
        train_ds = load_dataset(cfg, split=cfg.train_split)
    valid_ds = load_dataset(cfg, split="val")
    if cfg.vis_pose:
        raise NotImplementedError("--vis_pose is not ported yet (ROADMAP A7)")
    if cfg.data_format == "colmap":
        trainer.update_aabb(train_ds.pts_aabb)

    trainer.metrics = [PSNRMeter()]
    if cfg.stage == 1:
        trainer.train_stage1(train_ds, valid_ds)
    else:
        trainer.train(train_ds, valid_ds)

    # final eval on val + test (reference main.py:253-263)
    trainer.metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter()]
    trainer.evaluate(valid_ds, name="val_final", write_images=True)
    test_ds = load_dataset(cfg, split="test")
    if test_ds.has_gt:
        trainer.evaluate(test_ds, name="test", write_images=True)
    if not cfg.test_no_video:
        trainer.test_video(test_ds)

    if cfg.stage == 0 and cfg.sharpen_steps > 0 and not cfg.sdf:
        # mesh-preparation sharpening after the quality evals and before the
        # export (Config.sharpen_steps)
        trainer.log(f"[INFO] sharpen phase: +{cfg.sharpen_steps} steps @ "
                    f"entropy {cfg.sharpen_entropy}")
        trainer.train(train_ds, None, max_steps=cfg.iters + cfg.sharpen_steps)
        trainer.save_checkpoint()

    if cfg.stage == 1:
        trainer.export_stage1(resolution=cfg.texture_size)
    elif not cfg.test_no_mesh:
        trainer.save_mesh(
            resolution=cfg.mcubes_reso, decimate_target=cfg.decimate_target,
            dataset=train_ds if cfg.mesh_visibility_culling else None)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
