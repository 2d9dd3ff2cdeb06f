"""CLI entry point of the port (counterpart of nerf2mesh_tpu/main.py).

Usage:  python -m nerf2mesh_tpu_torch.main <blender dir> [flags of config.py]

Runs stage 0 on the first CUDA card: --ckpt latest|scratch|<path>, then
either --test (test eval with PSNR, SSIM and LPIPS, the test video) or
training with validation evals, the final val and test evals, the video,
and the sharpen phase (under -O or --sharpen_steps) and its checkpoint.  The
command line exits non-zero when there is no card; from Python,
``main(argv, device="cpu")`` runs on the CPU.

Not ported yet (NotImplementedError naming the ROADMAP item, raised before
any work): the stage-0 mesh export (A3: pass --test_no_mesh), stage 1 (A4),
SDF pretraining (A5), the colmap/dtu providers and more than one device
(A7); --vis_pose (A7) raises once the datasets are loaded.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None, device=None):
    """Run the stage-0 flow of nerf2mesh_tpu.main; returns the Trainer."""
    import torch

    from .config import parse_args
    from .data.provider import load_nerf_dataset as load_dataset
    from .utils.metrics import LPIPSMeter, PSNRMeter, SSIMMeter
    from .utils.trainer import Trainer, check_supported

    cfg = parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(
                "nerf2mesh_tpu_torch.main: no CUDA device found; the port "
                "runs on the card (from Python, main(argv, device='cpu') "
                "runs it on the CPU)")
        device = "cuda:0"
    if cfg.data_format != "nerf":
        raise NotImplementedError(f"the {cfg.data_format} provider is not "
                                  "ported yet (ROADMAP A7)")
    if any(int(n) > 1 for n in cfg.mesh_shape):
        raise NotImplementedError(
            f"mesh_shape {cfg.mesh_shape}: multi-device training is not "
            "ported yet (ROADMAP A7); the port runs on one device")
    check_supported(cfg)
    if cfg.stage == 0 and not cfg.test_no_mesh:
        # the run would end in Trainer.save_mesh: fail before any work
        raise NotImplementedError(
            "the stage-0 mesh export is not ported yet (ROADMAP A3); pass "
            "--test_no_mesh")

    np.random.seed(cfg.seed)
    trainer = Trainer(cfg, device=device)

    if cfg.ckpt == "latest":
        trainer.load_checkpoint()
    elif cfg.ckpt != "scratch" and cfg.ckpt:
        trainer.load_checkpoint(cfg.ckpt)

    if cfg.test:
        test_ds = load_dataset(cfg, split="test")
        if test_ds.has_gt:
            trainer.metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter()]
            trainer.evaluate(test_ds, name="test", write_images=True)
        if not cfg.test_no_video:
            trainer.test_video(test_ds)
        return trainer

    train_ds = load_dataset(cfg, split=cfg.train_split)
    valid_ds = load_dataset(cfg, split="val")
    if cfg.vis_pose:
        raise NotImplementedError("--vis_pose is not ported yet (ROADMAP A7)")

    trainer.metrics = [PSNRMeter()]
    trainer.train(train_ds, valid_ds)

    # final eval on val + test (reference main.py:253-263)
    trainer.metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter()]
    trainer.evaluate(valid_ds, name="val_final", write_images=True)
    test_ds = load_dataset(cfg, split="test")
    if test_ds.has_gt:
        trainer.evaluate(test_ds, name="test", write_images=True)
    if not cfg.test_no_video:
        trainer.test_video(test_ds)

    if cfg.sharpen_steps > 0:
        # mesh-preparation sharpening after the quality evals and before the
        # export (Config.sharpen_steps)
        trainer.log(f"[INFO] sharpen phase: +{cfg.sharpen_steps} steps @ "
                    f"entropy {cfg.sharpen_entropy}")
        trainer.train(train_ds, None, max_steps=cfg.iters + cfg.sharpen_steps)
        trainer.save_checkpoint()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
