"""Size of the same training state as an Orbax checkpoint written by the
JAX package (orbax + tensorstore, libzstd level 1) and by the port
(utils/orbax.py: raw and RLE zstd blocks), on the CPU.

    JAX_PLATFORMS=cpu python workspace/port/ocp_size.py [--steps N] [--small]

Builds the JAX Trainer at chip_smoke's bench configuration (or, with
--small, at the committed fixture's), trains it N steps on a 64^2
synthetic scene (0: the initial state), saves its .ocp, loads that into a
port Trainer and saves the port's .ocp of the same state; prints both
directories' MiB and checks that the port's loads back bit-equal.
"""

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from nerf2mesh_tpu.config import Config as JConfig  # noqa: E402
from nerf2mesh_tpu.data.provider import load_nerf_dataset  # noqa: E402
from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset  # noqa
from nerf2mesh_tpu.utils.trainer import Trainer as JTrainer  # noqa: E402
from nerf2mesh_tpu_torch.config import Config  # noqa: E402
from nerf2mesh_tpu_torch.utils.trainer import Trainer  # noqa: E402

BENCH = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=4096,
             num_points=2 ** 18, max_steps=1024, grid_size=128,
             diffuse_step=1000, random_image_batch=True,
             background="random", mark_untrained=True)
SMALL = dict(grid_size=16, num_levels=4, log2_hashmap_size=9, num_rays=256,
             num_points=4096, bound=1.0, scale=0.8, dt_gamma=0.0,
             random_image_batch=True)


def mib(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 2 ** 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    kw = SMALL if args.small else BENCH
    tmp = tempfile.mkdtemp()
    try:
        root = generate_synthetic_dataset(os.path.join(tmp, "scene"),
                                          H=64, W=64, n_train=4, n_val=1,
                                          n_test=0)
        jcfg = dataclasses.replace(JConfig(path=root), ckpt_backend="orbax",
                                   workspace=os.path.join(tmp, "jax"),
                                   **kw).finalize()
        jt = JTrainer(jcfg)
        if args.steps:
            ds = load_nerf_dataset(jcfg, "train")
            jt.mark_untrained(ds)
            jt.train_steps(ds, args.steps)
        jt.save_checkpoint()
        jpath = os.path.join(tmp, "jax", "checkpoints",
                             "ngp_stage0_latest.ocp")
        tcfg = dataclasses.replace(Config(path=root), ckpt_backend="orbax",
                                   workspace=os.path.join(tmp, "port"),
                                   **kw).finalize()
        t = Trainer(tcfg, device="cpu")
        assert t.load_checkpoint(jpath) and t.step == args.steps
        ppath = t.save_checkpoint()
        back = Trainer(tcfg, device="cpu")
        assert back.load_checkpoint(ppath)
        for (k, a), b in zip(t.params.named_parameters(),
                             back.params.parameters()):
            assert (a == b).all(), k
        n = sum(p.numel() for p in t.params.parameters())
        print(f"{'fixture' if args.small else 'bench'} config, "
              f"{args.steps} steps, {n} parameters: JAX .ocp "
              f"{mib(jpath):.2f} MiB, port .ocp {mib(ppath):.2f} MiB "
              f"({mib(ppath) / mib(jpath):.2f}x)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
