"""The port's entry points (nerf2mesh_tpu_torch/entry.py, the counterpart
of __graft_entry__.py) on the CPU: ``entry()``'s forward render gives finite
outputs of the documented shapes, and ``dryrun_multichip(2)`` runs the
data-parallel stage-0 step (plain and with dense depth) and the stage-1
step on two spawned gloo ranks.  Also the port's recipe scripts
(nerf2mesh_tpu_torch/scripts/): each names only the port, and every
command of the shell recipes and the capstone runs parses with the
port's ``parse_args``.
"""

import importlib
import math
import re
import shlex
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf2mesh_tpu_torch.config import parse_args
from nerf2mesh_tpu_torch.entry import dryrun_multichip, entry

SCRIPTS = Path(__file__).resolve().parent.parent / "nerf2mesh_tpu_torch" / \
    "scripts"


def test_entry_renders_on_the_cpu():
    fn, args = entry("cpu")
    image, depth, wsum = fn(*args)
    assert image.shape == (256, 3) and depth.shape == wsum.shape == (256,)
    for o in (image, depth, wsum):
        assert torch.isfinite(o).all()
    assert args[0].table.device.type == "cpu"


def test_dryrun_multichip_on_the_cpu():
    res = dryrun_multichip(2, device="cpu")
    for k in ("loss", "depth_loss", "stage1_loss"):
        assert math.isfinite(res[k]), res
    assert res["num_points"] > 0


def _commands(text):
    """The argument lists of the script's nerf2mesh_tpu_torch.main calls,
    shell variables replaced by placeholders."""
    text = text.replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        if "-m nerf2mesh_tpu_torch.main" not in line:
            continue
        args = line.split("-m nerf2mesh_tpu_torch.main", 1)[1]
        args = re.sub(r"\$\{?\w+\}?", "x", args)
        out.append(shlex.split(args))
    return out


@pytest.mark.parametrize("name", ["runall_syn.sh", "runall_syn_sdf.sh",
                                  "runall_llff.sh", "runall_360.sh",
                                  "runall_sdf_outdoor.sh"])
def test_shell_recipes_parse(name):
    cmds = _commands((SCRIPTS / name).read_text())
    assert len(cmds) == 2 or len(cmds) == 4, cmds
    stages = sorted(parse_args(c).stage for c in cmds)
    assert stages == sorted([0, 1] * (len(cmds) // 2))
    for c in cmds:
        cfg = parse_args(c)
        assert cfg.path == "x/x" and cfg.workspace.startswith("trial_")


@pytest.mark.parametrize("name", ["capstone_full_run", "capstone_hard_run"])
def test_capstone_flags_parse(name):
    mod = importlib.import_module(f"nerf2mesh_tpu_torch.scripts.{name}")
    s0 = parse_args(["scene"] + mod.STAGE0_ARGS)
    s1 = parse_args(["scene"] + mod.STAGE1_ARGS)
    assert (s0.stage, s1.stage) == (0, 1) and s1.refine
    assert s0.mesh_visibility_culling and s1.texture_size == 1024


def test_scripts_name_only_the_port():
    files = sorted(p for p in SCRIPTS.iterdir() if p.suffix in (".py", ".sh"))
    assert len(files) == 11, files
    pat = re.compile(r"\bjax\b|nerf2mesh_tpu(?!_torch)\b|/root/|/tmp/")
    bad = [f"{p.name}:{i}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pat.search(line) and "scripts/" not in line]
    assert not bad, bad
