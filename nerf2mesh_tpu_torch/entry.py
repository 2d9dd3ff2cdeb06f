"""Entry points for a quick check of the port (the counterpart of the JAX
repository's __graft_entry__.py): ``entry()`` gives the stage-0 forward
render and its example inputs, and ``dryrun_multichip(n)`` runs the
data-parallel training steps on n ranks at a tiny size.

    python -m nerf2mesh_tpu_torch.entry [n]      # on the card; n ranks (2)
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


def entry(device=None):
    """(fn, example_args): the stage-0 forward render of 256 rays through
    a fresh bench-width field (JAX __graft_entry__.py:38-66); fn returns
    (image [N, 3], depth [N], weights_sum [N]).  On the card the render
    goes through the occupancy and encode kernels."""
    from .models.network import NeRFField, NetworkSpec
    from .models.renderer import RenderSpec, render_train

    dev = _device(device)
    net_spec = NetworkSpec(bound=1.0)
    render_spec = RenderSpec(bound=1.0, grid_size=32, max_steps=64,
                             num_coarse=64, num_fine=16, dt_gamma=0.0)
    params = NeRFField(net_spec, torch.Generator().manual_seed(0)).to(dev)
    N = 256
    g = torch.Generator().manual_seed(1)
    rays_o = (torch.rand((N, 3), generator=g) * 0.2 - 0.1
              + torch.tensor([0.0, 0.0, 2.5]))
    rays_d = torch.randn((N, 3), generator=g)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    occ = torch.ones((1, 32, 32, 32), dtype=torch.uint8)
    bg = torch.ones((N, 3))

    @torch.no_grad()
    def fn(params, rays_o, rays_d, bg, occ):
        # u=None: samples at the bin centres (JAX's perturb=False)
        out = render_train(params, occ, rays_o, rays_d, bg, None,
                           render_spec, net_spec, full_flag=True)
        return out["image"], out["depth"], out["weights_sum"]

    return fn, (params, rays_o.to(dev), rays_d.to(dev), bg.to(dev),
                occ.to(dev))


def _tiny_cfg(num_points: int, num_rays: int):
    from .config import Config
    return dataclasses.replace(Config(path=""), **dict(
        bound=1.0, scale=0.8, dt_gamma=0.0, iters=100, num_rays=num_rays,
        num_points=num_points, max_steps=64, grid_size=32, diffuse_step=10,
        random_image_batch=True, background="random", lambda_specular=1e-5,
        lambda_tv=1e-8, lambda_depth=0.01)).finalize()


def _tiny_dataset(cfg):
    """Four 32x32 training views of the sphere scene."""
    from .data.provider import dataset_from_frames
    from .data.synthetic import render_synthetic_frames
    frames = render_synthetic_frames(H=32, W=32, n_train=4, n_val=0,
                                     n_test=0)
    return dataset_from_frames(cfg, frames, "train")


def uv_sphere():
    """A small UV sphere (radius 0.5) for the stage-1 step."""
    n_th, n_ph = 8, 10
    th = np.linspace(0.15, np.pi - 0.15, n_th)
    ph = np.linspace(0.0, 2 * np.pi, n_ph, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    v = 0.5 * np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                        np.cos(T)], -1).reshape(-1, 3)
    idx = np.arange(n_th * n_ph).reshape(n_th, n_ph)
    a, b = idx[:-1, :], idx[1:, :]
    c, d = np.roll(a, -1, axis=1), np.roll(b, -1, axis=1)
    f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                        np.stack([c, b, d], -1).reshape(-1, 3)])
    return v.astype(np.float32), f.astype(np.int32)


def _dryrun_rank(rank: int, n: int, workdir: str, device: str) -> None:
    """One rank of dryrun_multichip: the stage-0 step, again with dense
    depth, and the stage-1 step; rank 0 writes the results to
    <workdir>/result.json."""
    from . import kernels
    from .meshing.io import write_ply
    from .parallel import distributed
    from .utils.trainer import Trainer

    torch.set_num_threads(1)
    dev = distributed.init_distributed(
        device, init_method=f"file://{os.path.join(workdir, 'init')}",
        rank=rank, world_size=n)
    try:
        cfg = _tiny_cfg(num_points=1536 * n, num_rays=32 * n)
        trainer = Trainer(cfg, device=dev, workspace=workdir)
        ds = _tiny_dataset(cfg)
        images, poses, intr = trainer._prep_train_arrays(ds)
        kernels.reset_launches()
        m = trainer.train_step(images, poses, intr, cfg.num_rays,
                               trainer.dynamics(0))
        depth = {"dense": torch.full(images.shape[:3], 2.5, device=dev)}
        m_d = trainer.train_step(images, poses, intr, cfg.num_rays,
                                 trainer.dynamics(1), depth=depth)

        if rank == 0:
            v, f = uv_sphere()
            os.makedirs(os.path.join(workdir, "mesh_stage0"), exist_ok=True)
            write_ply(os.path.join(workdir, "mesh_stage0", "mesh_0.ply"),
                      v * 0.4, f)
        distributed.barrier()
        trainer.cfg = dataclasses.replace(cfg, stage=1, s1_crop=16, ssaa=2,
                                          s1_px_per_face=0.0)
        trainer.setup_stage1(ds)
        mvps = torch.from_numpy(ds.mvps).to(dev)
        m1 = trainer.stage1_step(images, poses, mvps, intr)
        res = {"loss": float(m["loss"]), "depth_loss": float(m_d["loss"]),
               "stage1_loss": float(m1["loss"]),
               "num_points": int(m["num_points"]),
               "launches": {k: v for k, v in kernels.LAUNCHES.items()
                            if v and "_c" not in k}}
        for k in ("loss", "depth_loss", "stage1_loss"):
            if not math.isfinite(res[k]):
                raise AssertionError(f"rank {rank}: non-finite {k} {res}")
        distributed.check_equal("the parameters after the dry run",
                                list(trainer.params.parameters())
                                + [trainer.vertices_offsets])
        if rank == 0:
            with open(os.path.join(workdir, "result.json"), "w") as fh:
                json.dump(res, fh)
            print(f"[dryrun_multichip] {n} ranks on {dev} OK: {res}",
                  flush=True)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int = 2, device: Optional[str] = None,
                     timeout: float = 600.0) -> dict:
    """Spawn n_devices ranks (gloo on the CPU or on one shared card, NCCL
    when there is a card a rank; parallel/distributed.py) that each run the
    data-parallel stage-0 step once plain and once with dense depth
    supervision, then the stage-1 step on a small sphere mesh, and check
    that every rank ends with the same parameters.  Returns rank 0's
    losses, point count and kernel launches; raises if a rank fails."""
    import torch.multiprocessing as mp

    dev = _device(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="n2m_dryrun_") as workdir:
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, n_devices, workdir, dev.type))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise RuntimeError(f"dryrun_multichip: rank exit codes {codes}"
                               f"{' (timed out)' if alive else ''}")
        with open(os.path.join(workdir, "result.json")) as fh:
            return json.load(fh)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("[entry] OK:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
