"""Data-parallel scaling of stage-0 training through the CLI: one run of
``nerf2mesh_tpu_torch.main`` at bench.py's configuration (chip_smoke's
``cli_argv``; val evals and checkpoints, no mesh or video), either as one
rank or, under ``torchrun``, as one rank a process.  Afterwards every rank
checks that its parameters, EMA weights and grid equal rank 0's, and rank
0 prints one line ``DP_RESULT {json}``: the world size, the backend, the
ms a logged step and rays/s over the second half of the run, the mean ms
of the gradients' all-reduce (CUDA events on the current stream around
the call, the wait for the other ranks included; no host synchronisation,
so the step keeps its overlap), the logged losses and the last eval.

    python3 nerf2mesh_tpu_torch/tools/dp_scaling.py --scene DIR --workspace WS --steps 128
    torchrun --nproc_per_node 4 nerf2mesh_tpu_torch/tools/dp_scaling.py --scene DIR --workspace WS4 --steps 128

The one-rank run writes a 256^2 sphere scene (24 train, 2 val and 2 test
views) to DIR when DIR holds none; start it first.  Compare the two runs
in one call on one machine, the one-rank run on either side.  Extra
arguments after ``--`` go to the CLI.  Runs on the card (``--cpu`` for the
CPU: gloo ranks).
"""

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke as cs                                        # noqa: E402
from nerf2mesh_tpu_torch.main import main                      # noqa: E402
from nerf2mesh_tpu_torch.parallel import distributed           # noqa: E402


def run(args, extra):
    if (int(os.environ.get("WORLD_SIZE", "1")) == 1 and not os.path.exists(
            os.path.join(args.scene, "transforms_train.json"))):
        from nerf2mesh_tpu_torch.data.synthetic import (
            generate_synthetic_dataset)
        generate_synthetic_dataset(args.scene, H=256, W=256, n_train=24,
                                   n_val=2, n_test=2)
    argv = cs.cli_argv(args.scene, args.workspace, iters=args.steps,
                       n_eval=1, n_ckpt=1, test_no_mesh=True,
                       test_no_video=True) + extra
    cuda = torch.cuda.is_available() and not args.cpu
    t0 = time.perf_counter()
    with cs.timed_grad_reduce(cuda) as reduce_ms:
        t = main(argv, device=None if cuda else "cpu")
    if cuda:
        torch.cuda.synchronize()
    reduce_ms = [f() for f in reduce_ms]
    wall = time.perf_counter() - t0
    distributed.check_equal("the stage-0 parameters, EMA and grid",
                            list(t.params.parameters())
                            + list(t.ema_params.values())
                            + [t.render.density_grid, t.render.occ_grid])
    tl = t.train_log
    a, b = tl[len(tl) // 2], tl[-1]
    res = dict(world=t.world, device=str(t.device),
               backend=(torch.distributed.get_backend()
                        if distributed.is_initialized() else None),
               ms_step=(b["seconds"] - a["seconds"]) / (b["step"] - a["step"])
               * 1e3, rays_per_s=(b["rays"] - a["rays"])
               / (b["seconds"] - a["seconds"]),
               steps=(a["step"], b["step"]), main_s=wall,
               allreduce_ms=(sum(reduce_ms) / len(reduce_ms)
                             if reduce_ms else None),
               losses=[round(e["loss"], 6) for e in tl],
               psnr=t.stats["results"][-1] if t.stats["results"] else None,
               bit_equal=True)
    if t.rank == 0:
        print("DP_RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    argv = sys.argv[1:]
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser()
    p.add_argument("--scene", required=True)
    p.add_argument("--workspace", required=True)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--cpu", action="store_true")
    run(p.parse_args(argv), extra)
