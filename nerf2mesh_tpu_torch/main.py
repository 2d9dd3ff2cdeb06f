"""CLI entry point of the port (counterpart of nerf2mesh_tpu/main.py).

Usage:  python -m nerf2mesh_tpu_torch.main <data dir> [flags of config.py]

The data dir is a blender scene (transforms_{split}.json; --downscale and
the trainval/all splits resize the frames) or a single transforms.json
(colmap2nerf.py's: every frame but the first trains, the first validates),
a DTU scene under --data_format dtu (cameras_sphere.npz, image/, mask/),
or a COLMAP capture under
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

--vis_pose writes the cameras, the box and a capture's sparse points to
<workspace>/poses.ply (utils/vis_pose.py) before training.

Data parallelism: under ``torchrun --nproc_per_node N -m
nerf2mesh_tpu_torch.main ...`` (WORLD_SIZE > 1) every rank trains its
share of each step's rays or crops (parallel/distributed.py picks the
backend and the rank's card), and rank 0 alone writes.  --mesh_shape is
JAX's device mesh: -1 (the default) takes every rank the launcher started,
and any other value must equal their number.

--ckpt_backend orbax writes the JAX trainer's Orbax .ocp checkpoint
directories (utils/orbax.py, without orbax, tensorstore or zstandard);
loading takes either kind, the JAX package's included.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np


def dataset_loader(cfg):
    """The provider of cfg.data_format (nerf, colmap or dtu)."""
    if cfg.data_format == "colmap":
        from .data.colmap import load_colmap_dataset
        return load_colmap_dataset
    if cfg.data_format == "dtu":
        from .data.dtu import load_dtu_dataset
        return load_dtu_dataset
    if cfg.data_format == "nerf":
        from .data.provider import load_nerf_dataset
        return load_nerf_dataset
    raise ValueError(f"unknown --data_format {cfg.data_format!r}")


def check_mesh_shape(mesh_shape, world: int) -> None:
    """--mesh_shape against the ranks the launcher started: (-1,) takes
    them all, any other shape must hold exactly `world` devices."""
    if tuple(mesh_shape) == (-1,):
        return
    want = int(np.prod(mesh_shape))
    if want == world:
        return
    if world == 1:
        raise ValueError(
            f"--mesh_shape {' '.join(map(str, mesh_shape))} asks for {want} "
            f"devices but this process is one rank; launch one rank a "
            f"device: torchrun --nproc_per_node {want} -m "
            f"nerf2mesh_tpu_torch.main ...")
    raise ValueError(f"--mesh_shape {' '.join(map(str, mesh_shape))} asks "
                     f"for {want} devices but the launcher started {world} "
                     f"ranks")


def main(argv: Optional[List[str]] = None, device=None):
    """Run the flow of nerf2mesh_tpu.main; returns the Trainer."""
    import torch

    from .config import parse_args
    from .parallel import distributed
    from .utils.metrics import LPIPSMeter, PSNRMeter, SSIMMeter
    from .utils.trainer import Trainer

    cfg = parse_args(argv)
    if device is None and not torch.cuda.is_available():
        raise SystemExit(
            "nerf2mesh_tpu_torch.main: no CUDA device found; the port "
            "runs on the card (from Python, main(argv, device='cpu') "
            "runs it on the CPU)")
    if (int(os.environ.get("WORLD_SIZE", "1")) > 1
            and not distributed.is_initialized()):
        device = distributed.init_distributed(device)
    check_mesh_shape(cfg.mesh_shape, distributed.world_size())
    if device is None:
        device = "cuda:0"
    load_dataset = dataset_loader(cfg)

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
    if cfg.vis_pose and trainer.rank == 0:
        from .utils.vis_pose import write_pose_vis
        path = write_pose_vis(trainer.workspace, train_ds.poses, cfg.bound,
                              points=train_ds.pts3d)
        trainer.log(f"[INFO] --vis_pose wrote {path}")
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
