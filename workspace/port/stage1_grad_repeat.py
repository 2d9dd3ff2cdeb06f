"""How far two passes of one stage-1 crop's offsets' gradient differ: the
kernels' pass against itself and against the plain encode's, with and
without PyTorch's deterministic algorithms.

    python3 workspace/port/stage1_grad_repeat.py [--crops 64] [--out PATH]

Runs chip_smoke.py's phase 9 (SDF at bench width: pretrain, stage 0, the
mesh, 16 stage-1 steps under enable_offset_nerf_grad) and, before its own
check of the offsets' gradient, draws `--crops` crops and on each takes
the relative L2 difference of the offsets' gradient between: a second
kernels' pass and the first (repeat), the plain encode's pass and the
kernels' (plain), and the same two under chip_smoke.deterministic()
(det_repeat, det_plain, and det_plain_repeat between two plain passes),
the plain pass given the kernels' gradient at the rendered image
(det_plain_cot, chip_smoke.image_cotangent) and its image's largest
difference from the kernels' (image_err), with each crop's field share.  Prints one line a measure (max, median,
count over 1e-3 and 1e-4, count exactly 0) and a last line
``STAGE1_GRAD_REPEAT {json}`` of those; the per-crop rows go to --out.
Needs a CUDA card.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, REPO)

import chip_smoke as cs                                        # noqa: E402


def compare(t1, ds, crops):
    """The per-crop rows and the seconds a pass took, free and within
    deterministic()."""
    images, poses, intr = t1._prep_train_arrays(ds)
    mvps = torch.from_numpy(np.asarray(ds.mvps, np.float32)).to(t1.device)
    B, H, W, _ = images.shape
    cfg = t1.cfg
    secs = {"free": [], "det": []}

    def grad(draws, flag, plain=False, det=False, cot=None, replay=False):
        t1.cfg = dataclasses.replace(cfg, enable_offset_nerf_grad=flag)
        t1.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cs.inwin_calls(None, plain), (
                cs.deterministic() if det else contextlib.nullcontext()), (
                contextlib.nullcontext() if cot is None
                else cs.image_cotangent(cot, replay)):
            loss, _, _, _ = t1._stage1_crop_loss(images, poses, mvps, intr,
                                                 draws)
            loss.backward()
        torch.cuda.synchronize()
        secs["det" if det else "free"].append(time.perf_counter() - t0)
        return t1.vertices_offsets.grad.detach().clone()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    rows = []
    try:
        for _ in range(crops):
            draws = t1.stage1_draw(B, H, W)
            k = grad(draws, True)
            k2 = grad(draws, True)
            p = grad(draws, True, plain=True)
            cot = {}
            dk = grad(draws, True, det=True, cot=cot)
            dk2 = grad(draws, True, det=True)
            dp = grad(draws, True, plain=True, det=True)
            dp2 = grad(draws, True, plain=True, det=True)
            dc = grad(draws, True, plain=True, det=True, cot=cot,
                      replay=True)
            without = grad(draws, False)
            rows.append(dict(
                share=float((k - without).norm() / k.norm()),
                repeat=rel(k2, k), plain=rel(p, k),
                det_repeat=rel(dk2, dk), det_plain=rel(dp, dk),
                det_plain_repeat=rel(dp2, dp), det_plain_cot=rel(dc, dk),
                image_err=float((cot["replayed"] - cot["image"]).abs()
                                .max())))
    finally:
        t1.cfg = cfg
        t1.optimizer.zero_grad(set_to_none=True)
    return rows, {k: float(np.median(v)) for k, v in secs.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--crops", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "stage1_grad_repeat.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage1_grad_repeat: needs a CUDA card", file=sys.stderr)
        return 2
    card, _ = cs.phase_device()
    print(card, flush=True)
    cs.phase_build()
    real = cs.offsets_field_share
    summary = {}

    def measured(t1, ds, crops=cs.SDF_SHARE_CROPS):
        rows, secs = compare(t1, ds, args.crops)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f)
        summary["pass_s"] = secs
        for key in rows[0]:
            v = np.array([r[key] for r in rows], float)
            summary[key] = dict(max=float(v.max()), median=float(np.median(v)),
                                over_1e3=int((v > 1e-3).sum()),
                                over_1e4=int((v > 1e-4).sum()),
                                zero=int((v == 0).sum()))
            cs.log(f"[grad repeat] {key}: {summary[key]}")
        cs.log(f"[grad repeat] median seconds a pass: {secs}")
        return real(t1, ds, crops)

    cs.offsets_field_share = measured
    try:
        cs.phase_sdf(torch.device("cuda", 0))
    finally:
        cs.offsets_field_share = real
    summary["crops"] = args.crops
    summary["card"] = card
    print("STAGE1_GRAD_REPEAT " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
