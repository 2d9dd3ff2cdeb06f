"""Typed configuration for the nerf2mesh pipeline (PyTorch port).

A copy of ``nerf2mesh_tpu/config.py``: the port imports nothing of the JAX
package, so it carries the same dataclass and CLI surface itself, and
tests/test_torch_slice.py holds the two copies field-for-field equal.  TPU
remarks in the field comments describe the JAX package's use of a field.

Mirrors the flag surface of the reference CLI (reference main.py:12-124),
including the ``-O`` recommended-settings macro (main.py:129-136) and the ``--sdf``
derived-flag cascade (main.py:138-153), but as a frozen-ish dataclass instead of a
mutable argparse namespace.  Values that the reference mutates at runtime
(``num_rays`` under adaptive ray batching, ``cos_anneal_ratio``, ``max_level``) are
explicit training-loop state here, not config (SURVEY.md §5.6).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Config:
    # paths / mode
    path: str = ""
    workspace: str = "workspace"
    seed: int = 0
    stage: int = 0
    ckpt: str = "latest"
    # checkpoint serialization: "pickle" (single portable file) or "orbax"
    # (directory per checkpoint: checksummed OCDBT arrays + JSON metadata,
    # partial/merging restore on schema drift).  Loading auto-detects the
    # format, so runs can switch backends mid-training.
    ckpt_backend: str = "pickle"
    fp16: bool = False            # on TPU this selects bf16 compute for the networks
    sdf: bool = False
    progressive_level: bool = False

    # testing
    tcnn: bool = False           # accepted for CLI compat; the TPU hashgrid
                                 # is always the native implementation
    criterion: str = "mse"       # mse | mape | huber (reference main.py:187)

    test: bool = False
    test_no_video: bool = False
    test_no_mesh: bool = False
    camera_traj: str = ""

    # dataset
    data_format: str = "nerf"     # nerf | colmap | dtu
    train_split: str = "train"    # train | trainval | all
    preload: bool = False
    random_image_batch: bool = False
    downscale: int = 1
    bound: float = 2.0
    scale: float = -1.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    mesh: str = ""
    enable_cam_near_far: bool = False
    enable_cam_center: bool = False
    min_near: float = 0.05
    enable_sparse_depth: bool = False
    enable_dense_depth: bool = False

    # training
    iters: int = 30000
    lr: float = 1e-2
    lr_vert: float = 1e-4
    # stage-1 training crop side (pixels); 0 = full frame up to 256.
    # The reference renders full frames per stage-1 step; crops trade
    # per-step cost against vertex-gradient coverage
    s1_crop: int = 0
    # stage-1 silhouette treatment (see models/stage1.render_stage1_crop):
    # "area" = exact per-pixel union area coverage (unbiased, dense vertex
    # gradients; round-4 default — the oracle probe measured "aa"/"hard"
    # under-covering rims by ~0.09 alpha at perfect geometry); "aa" = strict
    # coverage + analytic edge antialiasing (dr.antialias analog); "hard" =
    # strict coverage only; "soft" = signed-distance sigmoid (legacy).
    s1_alpha: str = "area"
    # stage-1 trains with the stochastic 1-corner encode (opt-in: the
    # estimator noise lands undamped on single surface queries — v6 capstone)
    s1_stochastic: bool = False
    s1_alpha_eval: str = "area"
    # stage-1 surface shading: >1 composites s1_shell samples along the view
    # ray in an s1_shell_h-wide shell around the surface with the field's
    # own (stop-graded) transmittance weights, replacing the single point
    # sample.  The single sample aliases against the density ramp wherever
    # vertex placement error exceeds the finest hash cell — the round-5 v9
    # decomposition measured 78-92% of held-out stage-1 MSE as interior
    # triangle-scale speckle from exactly this (reference renderer.py:877
    # single-samples and compensates with 800^2 x 30k-iter supervision
    # density this proxy cannot match).  Train and eval share the estimator.
    s1_shell: int = 1
    s1_shell_h: float = 0.02
    # stage-1 face budget as supersampled-pixels per face (2*H*W*ssaa^2 /
    # this); keeps triangles big enough that the antialias edge-crossing
    # gradient can train vertex offsets.  0 disables (raster cap only).
    s1_px_per_face: float = 6.0
    # vertex-offset lr starts at s1_vert_boost*lr_vert and decays to lr_vert
    # over the run (movement budget ~ reference's 30k iters at lr_vert)
    s1_vert_boost: float = 30.0
    # snap fresh stage-1 vertices to the stage-0 field's apparent surface
    # (volume-render expected depth along the vertex normal) before training:
    # marching cubes' sigma=thresh isosurface sits systematically outside the
    # rendered surface, and interior vertices have no photometric gradient to
    # fix it (xyz detached, renderer.py:877-879).  NGP mode only (SDF meshes
    # at the 0-level are already apparent).
    s1_snap_surface: bool = True
    pos_gradient_boost: float = 1.0
    max_steps: int = 1024
    update_extra_interval: int = 16
    # stage-0 train steps per device dispatch (lax.scan chunk) in the JAX
    # package, where each TPU dispatch through its relay was costly
    # (PERF_TPU.md); chunking to the grid-update cadence amortizes it.  The
    # port runs one step per Python iteration and ignores it.
    steps_per_dispatch: int = 16
    max_ray_batch: int = 4096
    grid_size: int = 128
    mark_untrained: bool = False
    dt_gamma: float = 1.0 / 256
    density_thresh: float = 10.0
    diffuse_step: int = 1000
    diffuse_only: bool = False
    background: str = "random"    # white | random
    enable_offset_nerf_grad: bool = False
    n_eval: int = 5
    n_ckpt: int = 50

    # batch sizing
    num_rays: int = 4096
    adaptive_num_rays: bool = False
    num_points: int = 2 ** 18
    # compact valid samples into a fixed pool before the field evaluation
    # (encoder+MLP cost O(num_points) instead of O(num_rays*samples_per_ray))
    pool_points: bool = True
    # train-only stochastic 1-corner sampling on gather-routed fine hash
    # levels: unbiased trilinear estimate at 8x fewer random table rows.
    # Default ON: the hard-proxy A/B measured it BETTER than exact
    # trilinear at equal steps (28.29 vs 26.10 dB val PSNR, SSIM 0.963 vs
    # 0.932 — the per-step corner noise regularizes the fine tables) at
    # ~2x the training throughput.  --no-stochastic_fine restores exact.
    stochastic_fine: bool = True
    # exact window-sorted splat kernel for fine hash levels (sort points by
    # block-window id per level; MXU matmuls + ~18% crossing-corner residual
    # instead of an 8-corner random gather).  Exact, so it also serves eval;
    # ignored on levels where stochastic_fine applies
    winsort_fine: bool = False

    # TPU-specific batch layout: field samples per ray (dense [N, K] layout).
    # The reference marches a variable number of points per ray (up to
    # max_steps) through an atomic counter (raymarching.cu:332-489); on TPU we
    # place a fixed number of samples per ray by occupancy-importance
    # resampling (ops/sampling.py) — empty space gets no samples, shapes stay
    # static, and no gather/compaction is needed.
    samples_per_ray: int = 32
    # coarse occupancy candidates per ray (pass 1 of the sampler); unbounded
    # scenes with long [near, far] spans may want 256
    coarse_per_ray: int = 128

    # stage-0 regularizations
    lambda_density: float = 0.0
    lambda_entropy: float = 0.0
    # SHARPEN phase (stage 0, after the final evals, before mesh export):
    # extra train steps with the weight-entropy loss stepped up to
    # sharpen_entropy (first half at 0.1x — the validated ramp).  A
    # converged field renders volumetrically with a ~40-fine-cell soft
    # transmittance ramp, which breaks every surface shading estimator
    # stage 1 relies on (round-5 ramp probe: point sample 24.3 dB ->
    # 33.9 after sharpening, with interior volumetric quality intact);
    # the reference implicitly depends on a sharp field for its stage-1
    # (renderer.py:877) and the quality evals report PRE-sharpen numbers.
    sharpen_steps: int = 0
    sharpen_entropy: float = 1e-2
    lambda_tv: float = 1e-8
    lambda_depth: float = 0.1
    lambda_specular: float = 1e-5
    lambda_eikonal: float = 0.1
    lambda_rgb: float = 1.0
    lambda_mask: float = 0.1

    # stage-1 regularizations
    wo_smooth: bool = False
    lambda_lpips: float = 0.0
    lambda_offsets: float = 0.1
    lambda_lap: float = 0.001
    lambda_normal: float = 0.0
    lambda_edgelen: float = 0.0

    # misc
    contract: bool = False
    patch_size: int = 1
    trainable_density_grid: bool = False
    color_space: str = "srgb"
    ind_dim: int = 0
    ind_num: int = 500

    # mesh (stage 0)
    mcubes_reso: int = 512
    env_reso: int = 256
    decimate_target: float = 3e5
    mesh_visibility_culling: bool = False
    visibility_mask_dilation: int = 5
    clean_min_f: int = 8
    clean_min_d: int = 5

    # mesh (stage 1)
    ssaa: int = 2
    texture_size: int = 4096
    refine: bool = False
    refine_steps_ratio: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.7)
    refine_size: float = 0.01
    refine_decimate_ratio: float = 0.1
    refine_remesh_size: float = 0.02

    # GUI analog (offline viewer options)
    vis_pose: bool = False
    gui: bool = False
    viewer_train: bool = False   # viewer interleaves 16-step training chunks
    #                              (reference gui.py:106-128 train mode)
    W: int = 1000
    H: int = 1000
    radius: float = 5.0
    fovy: float = 50.0
    max_spp: int = 1

    # encoder size (reference network.py:66-71 fixes L=16, hashmap 2^19).
    # log2_hashmap_size <= 14 activates the Pallas VMEM sweep encoder on TPU
    # (see ops/pallas_encode.py; large tables use the XLA path).
    num_levels: int = 16
    log2_hashmap_size: int = 19
    # hash-table indexing layout: "block512" hashes at 8^3-block granularity
    # (enables the splat-contraction Pallas encoder at full table sizes,
    # ops/splat_encode.py); "ref" matches the reference's per-entry hash
    # (gridencoder.cu:50-63) exactly.  Same table size and collision count
    # either way; collisions are spatially block-correlated under block512
    # (quality A/B: workspace/ab/layout_ab.py).
    grid_layout: str = "block512"

    # parallelism (TPU-native; no analog in the reference, which is single-GPU)
    mesh_shape: Tuple[int, ...] = (-1,)   # device mesh; -1 = all local devices
    mesh_axes: Tuple[str, ...] = ("data",)

    # ---- derived (filled by finalize) ----
    refine_steps: Tuple[int, ...] = ()
    cos_anneal_ratio: float = 0.0          # initial value; trainer owns the schedule

    def finalize(self, O: bool = False) -> "Config":
        """Apply the reference's derived-flag cascade (main.py:127-181)."""
        cfg = dataclasses.replace(self)
        if O:
            cfg.fp16 = True
            cfg.preload = True
            cfg.mark_untrained = True
            cfg.random_image_batch = True
            cfg.mesh_visibility_culling = True
            cfg.adaptive_num_rays = True
            cfg.refine = True
            if cfg.sharpen_steps == 0 and cfg.stage == 0 and not cfg.sdf:
                # recommended two-stage recipe includes the mesh-prep
                # sharpen phase (0 = auto; pass -1 to force off)
                cfg.sharpen_steps = 1200
            if cfg.stage == 1 and not cfg.sdf and cfg.s1_shell <= 1:
                # recommended stage-1 shading: thin-shell composite with
                # stochastic train layers (round-5 capstone: +4.9 dB over
                # the single-sample path, and the held-out decline is gone)
                cfg.s1_shell = 4
                cfg.s1_stochastic = True
        if cfg.sharpen_steps < 0:
            cfg.sharpen_steps = 0
        if cfg.sdf:
            cfg.density_thresh = 0.001
            if cfg.stage == 0:
                cfg.progressive_level = True
            if cfg.bound > 1:
                cfg.contract = True
            cfg.enable_offset_nerf_grad = True
            cfg.refine_decimate_ratio = 0.0
            cfg.refine_size = 0.0
        if cfg.contract:
            cfg.mark_untrained = False
        if cfg.wo_smooth:
            cfg.lambda_offsets = 0.0
            cfg.lambda_lap = 0.0
            cfg.lambda_normal = 0.0
        if cfg.enable_sparse_depth:
            cfg.random_image_batch = False
        if cfg.patch_size > 1:
            assert cfg.num_rays % (cfg.patch_size ** 2) == 0, \
                "patch_size ** 2 should divide num_rays"
        cfg.refine_steps = tuple(int(round(x * cfg.iters)) for x in cfg.refine_steps_ratio)
        return cfg

    # --- geometry helpers shared by renderer/meshing (renderer.py:74-88) ---
    @property
    def real_bound(self) -> float:
        return self.bound

    @property
    def grid_bound(self) -> float:
        """Bound used for grid/hash queries; contraction maps to [-2, 2]."""
        return 2.0 if self.contract else self.bound

    @property
    def cascades(self) -> int:
        return 1 + int(math.ceil(math.log2(max(self.grid_bound, 1.0)))) if self.grid_bound > 1 else 1


_BOOL_FLAGS = {
    f.name for f in dataclasses.fields(Config)
    if f.type in ("bool",) and f.name not in ("refine_steps",)
}


def build_parser() -> argparse.ArgumentParser:
    """argparse surface that is flag-compatible with the reference CLI."""
    p = argparse.ArgumentParser(description="nerf2mesh-tpu")
    p.add_argument("path", type=str, nargs="?", default="")
    p.add_argument("-O", action="store_true", dest="O", help="recommended settings")
    defaults = Config()
    for f in dataclasses.fields(Config):
        if f.name in ("path", "refine_steps", "cos_anneal_ratio"):
            continue
        flag = f"--{f.name}"
        val = getattr(defaults, f.name)
        if f.name == "refine_steps_ratio":
            p.add_argument(flag, type=float, action="append", default=None)
        elif f.name in ("offset", "mesh_shape", "mesh_axes"):
            typ = str if f.name == "mesh_axes" else (float if f.name == "offset" else int)
            p.add_argument(flag, type=typ, nargs="*", default=list(val))
        elif isinstance(val, bool):
            if val:
                # True-default booleans (e.g. pool_points) must keep their
                # dataclass default through the CLI; a bare store_true would
                # silently flip them off for every CLI run (this pinned the
                # adaptive ray cap at the dense-layout bound and disabled
                # pool compaction in all main.py runs)
                p.add_argument(flag, action=argparse.BooleanOptionalAction,
                               default=True)
            else:
                p.add_argument(flag, action="store_true", default=False)
        else:
            p.add_argument(flag, type=type(val), default=val)
    return p


def parse_args(argv: Optional[List[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    d = vars(ns).copy()
    O = d.pop("O", False)
    if d.get("refine_steps_ratio") is None:
        d["refine_steps_ratio"] = Config.refine_steps_ratio
    else:
        d["refine_steps_ratio"] = tuple(d["refine_steps_ratio"])
    for k in ("offset", "mesh_shape", "mesh_axes"):
        d[k] = tuple(d[k])
    cfg = Config(**d)
    return cfg.finalize(O=O)
