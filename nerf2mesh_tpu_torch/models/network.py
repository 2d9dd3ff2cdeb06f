"""NeRF field network (port of nerf2mesh_tpu/models/network.py, NGP mode).

Architecture (as the JAX package's merged-table default):
  * one block512 hash table [total, 3]: channel 0 feeds the density MLP,
    channels 1..2 the color MLP; or, with ``separate_tables`` (the
    reference's own two encoders), ``sigma_table`` [total, 1] for the
    density and ``color_table`` [total, 2] for the color, each encoded by
    the same kernels at its own channel count;
  * density:  concat(x, h0 [L]) -> MLP(3+L -> 32 -> 1) -> trunc_exp;
  * color:    concat(x, h12 [2L]) -> MLP(-> 64 -> 64 -> 3+spec) -> sigmoid;
  * specular: MLP(3 dir + spec -> 32 -> 3) -> sigmoid; full color =
    clamp(diffuse + specular, 0, 1) once full shading is on.

The encode is routed by the table spec, as the JAX package's ``_encode``:
a block512 table takes the splat path (ops/splat_encode.py), with the points
morton-sorted once around the whole field and only the narrow [N, 7]
(sigma, color, specular) output unsorted; a small "ref" table takes the
sweep encode (ops/pallas_encode.py, kernel K4), unsorted; any other ref
table the plain ``hashgrid_encode``.  Parameters keep the JAX pytree layout:
``table`` [total, 3] (or ``sigma_table`` and ``color_table``) and
``*_net.<layer>.w`` [in, out] (utils/convert.py maps between the two).

The field covers [-bound, bound]^3 of its spec (the grid bound: the
scene's bound, or 2 under contraction), with the finest level at 2048 *
bound cells.  SDF mode adds the central-difference normal
(``finite_diff_normal``) and the double-sphere pretraining loss
(``sdf_pretrain_loss``).  Per-image codes (``ind_dim`` > 0): an
``individual_codes`` [ind_num, ind_dim] table whose rows join the colour
MLP's input; training passes each ray's view's code (``c``), and every
other colour query (eval, the export's bake, the stage-1 eval) takes code
0, the reference's fixed code for views it has not seen.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.activation import trunc_exp
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid
from ..ops.pallas_encode import sweep_encode, sweep_supported
from ..ops.splat_encode import (morton_perm, permute, splat_encode,
                                splat_supported)
from .mlp import MLP


@dataclass(frozen=True)
class NetworkSpec:
    bound: float = 1.0            # grid bound (2 when contracted)
    sdf: bool = False
    specular_dim: int = 3
    ind_dim: int = 0
    ind_num: int = 500
    fp16: bool = False            # bf16 compute for the MLPs
    # two tables, sigma_table (C=1) and color_table (C=2), as the
    # reference's two encoders, in place of the merged C=3 table; no CLI
    # flag sets it (nor in the JAX package)
    separate_tables: bool = False
    log2_hashmap_size: int = 19
    num_levels: int = 16
    grid_layout: str = "block512"
    # splat-encoder routing: levels evaluated by plain gather instead of the
    # window kernels (the trainer's residual-rate probe rewires this)
    encode_gather_levels: Tuple[int, ...] = ()
    # train-only unbiased 1-corner sampling of gather levels and residuals
    encode_stochastic: bool = False
    # exact window-sorted kernels (K5/K6) for those of the gather levels that
    # are also listed here; encode_stochastic takes precedence when set
    encode_winsort_levels: Tuple[int, ...] = ()

    @property
    def density_grid_spec(self) -> HashGridSpec:
        return HashGridSpec(
            num_levels=self.num_levels,
            level_dim=1 if self.separate_tables else 3,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(2048 * self.bound), interpolation="linear",
            layout=self.grid_layout,
        )

    @property
    def color_grid_spec(self) -> HashGridSpec:
        if not self.separate_tables:
            return self.density_grid_spec
        return dataclasses.replace(self.density_grid_spec, level_dim=2)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.fp16 else torch.float32


class NeRFField(nn.Module):
    """Parameters of the stage-0 field; the math is in the functions below."""

    def __init__(self, spec: NetworkSpec, generator: torch.Generator):
        super().__init__()
        L, sd = spec.num_levels, spec.specular_dim
        if spec.separate_tables:
            self.sigma_table = nn.Parameter(
                init_hashgrid(generator, spec.density_grid_spec))
            self.color_table = nn.Parameter(
                init_hashgrid(generator, spec.color_grid_spec))
        else:
            self.table = nn.Parameter(
                init_hashgrid(generator, spec.density_grid_spec))
        self.sigma_net = MLP(3 + L, 1, 32, 2, generator)
        self.color_net = MLP(3 + 2 * L + spec.ind_dim, 3 + sd, 64, 3,
                             generator)
        self.specular_net = MLP(sd + 3, 3, 32, 2, generator)
        if spec.sdf:
            self.variance = nn.Parameter(torch.tensor(0.3))
        if spec.ind_dim > 0:
            self.individual_codes = nn.Parameter(torch.randn(
                (spec.ind_num, spec.ind_dim), generator=generator,
                device=generator.device) * 0.1)


def _mask_levels(h, max_level, gspec: HashGridSpec):
    L, C = gspec.num_levels, gspec.level_dim
    if max_level is None or int(max_level) >= L:
        return h
    keep = torch.arange(L, device=h.device) < int(max_level)
    return (h.reshape(-1, L, C) * keep[None, :, None]).reshape(-1, L * C)


def _encode(table, x01, gspec: HashGridSpec, max_level, spec: NetworkSpec,
            pre_sorted: bool = False):
    """Hash encode routed by the table spec (JAX network._encode): block512
    -> the splat path with its per-level routing; a small ref table -> the
    sweep encode (K4); any other -> hashgrid_encode.  Returns (features,
    per-level residual counts, or None off the splat path)."""
    if splat_supported(gspec):
        h, cnt = splat_encode(table, x01, gspec, sort=not pre_sorted,
                              gather_levels=spec.encode_gather_levels,
                              stochastic=spec.encode_stochastic,
                              winsort_levels=(() if spec.encode_stochastic
                                              else spec.encode_winsort_levels))
        return _mask_levels(h, max_level, gspec), cnt
    if sweep_supported(gspec):
        return _mask_levels(sweep_encode(table, x01, gspec), max_level,
                            gspec), None
    return hashgrid_encode(table, x01, gspec, max_level), None


def encode_fields(params: NeRFField, x01: torch.Tensor, spec: NetworkSpec,
                  max_level: Optional[int] = None, pre_sorted: bool = False,
                  color: bool = True):
    """One pass over the merged table -> (density feats [N, L], color feats
    [N, 2L], per-level residual counts [L] or None).  Under separate tables
    each table is encoded on its own and the counts add up (JAX
    encode_fields); color=False skips the colour table there (its features
    are then None)."""
    L = spec.num_levels
    if spec.separate_tables:
        hd, c1 = _encode(params.sigma_table, x01, spec.density_grid_spec,
                         max_level, spec, pre_sorted)
        if not color:
            return hd, None, c1
        hc, c2 = _encode(params.color_table, x01, spec.color_grid_spec,
                         max_level, spec, pre_sorted)
        cnt = None if c1 is None else c1 + (0 if c2 is None else c2)
        return hd, hc, cnt
    h, cnt = _encode(params.table, x01, spec.density_grid_spec, max_level,
                     spec, pre_sorted)
    h = h.reshape(x01.shape[0], L, 3)
    return h[:, :, 0], h[:, :, 1:].reshape(x01.shape[0], 2 * L), cnt


def _density_from_feat(params: NeRFField, x, hd, spec: NetworkSpec):
    h = params.sigma_net(torch.cat([x.float(), hd], dim=-1),
                         spec.compute_dtype)
    if spec.sdf:
        return h[..., 0]
    return trunc_exp(h[..., 0])


def _geo_feat_from_feat(params: NeRFField, x, hc, spec: NetworkSpec, c=None):
    """c: per-image codes [N, ind_dim] or [1, ind_dim]; None takes code 0
    (under ind_dim > 0)."""
    h = torch.cat([x.float(), hc], dim=-1)
    if spec.ind_dim > 0:
        if c is None:
            c = params.individual_codes[:1]
        h = torch.cat([h, c.expand(x.shape[0], -1)], dim=-1)
    return torch.sigmoid(params.color_net(h, spec.compute_dtype))


def density(params: NeRFField, x: torch.Tensor, spec: NetworkSpec,
            max_level: Optional[int] = None) -> torch.Tensor:
    """sigma (after trunc_exp), or the raw SDF value in SDF mode.  x: [N, 3]
    in [-bound, bound].  Under separate tables only sigma_table is encoded
    (JAX's density encodes both and drops the colour features: the same
    value, one table's kernel launches fewer)."""
    b = spec.bound
    if not splat_supported(spec.density_grid_spec):
        hd, _, _ = encode_fields(params, (x + b) / (2 * b), spec, max_level,
                                 color=False)
        return _density_from_feat(params, x, hd, spec)
    # the splat path sorts the points once around the whole field
    perm, inv = morton_perm((x + b) / (2 * b))
    xs = permute(x, perm, inv)
    hd, _, _ = encode_fields(params, (xs + b) / (2 * b), spec, max_level,
                             pre_sorted=True, color=False)
    sig = _density_from_feat(params, xs, hd, spec)
    return permute(sig, inv, perm)


def field_forward(params: NeRFField, x: torch.Tensor, d: torch.Tensor,
                  spec: NetworkSpec, full_flag: bool,
                  max_level: Optional[int] = None, c=None):
    """Hot-path forward: ONE hash-table pass -> (sigma [N], color [N, 3],
    specular [N, 3], encode residual counts [L] or None).  full_flag selects
    full (diffuse + specular) shading over diffuse-only; c: the points'
    per-image codes (see _geo_feat_from_feat)."""
    b = spec.bound
    splat = splat_supported(spec.density_grid_spec)
    if splat:
        perm, inv = morton_perm((x + b) / (2 * b))
        x = permute(x, perm, inv)
        d = permute(d, perm, inv)
        if c is not None and c.shape[0] == x.shape[0]:
            c = permute(c, perm, inv)

    hd, hc, cnt = encode_fields(params, (x + b) / (2 * b), spec, max_level,
                                pre_sorted=splat)
    sigma = _density_from_feat(params, x, hd, spec)
    gf = _geo_feat_from_feat(params, x, hc, spec, c)
    diffuse = gf[..., :3]
    specular = _specular(params, d, gf, spec)
    if full_flag:
        color = (diffuse + specular).clamp(0.0, 1.0)
    else:
        color = diffuse
        specular = torch.zeros_like(specular)

    if not splat:
        return sigma, color, specular, cnt
    packed = torch.cat([sigma[:, None], color, specular], dim=-1)  # [N, 7]
    packed = permute(packed, inv, perm)
    return packed[:, 0], packed[:, 1:4], packed[:, 4:7], cnt


def geo_feat(params: NeRFField, x: torch.Tensor, spec: NetworkSpec,
             max_level: Optional[int] = None, c=None) -> torch.Tensor:
    """sigmoid(color_net(...)) = [diffuse 3 | specular feature] [N, 3+spec]
    (JAX network.geo_feat; the encode sorts and unsorts internally)."""
    b = spec.bound
    _, hc, _ = encode_fields(params, (x + b) / (2 * b), spec, max_level)
    return _geo_feat_from_feat(params, x, hc, spec, c)


def _specular(params: NeRFField, d, gf, spec: NetworkSpec):
    spec_in = torch.cat([d.float(), gf[..., 3:]], dim=-1)
    return torch.sigmoid(params.specular_net(spec_in, spec.compute_dtype))


def rgb(params: NeRFField, x: torch.Tensor, d: torch.Tensor,
        spec: NetworkSpec, shading: str = "full",
        max_level: Optional[int] = None, c=None):
    """(color [N, 3], specular [N, 3] or None) for shading "full",
    "diffuse" or "specular"; d normalized (JAX network.rgb)."""
    gf = geo_feat(params, x, spec, max_level, c)
    diffuse = gf[..., :3]
    if shading == "diffuse":
        return diffuse, None
    specular = _specular(params, d, gf, spec)
    if shading == "specular":
        return specular, specular
    return (diffuse + specular).clamp(0.0, 1.0), specular


def rgb_train(params: NeRFField, x: torch.Tensor, d: torch.Tensor,
              spec: NetworkSpec, full_flag: bool,
              max_level: Optional[int] = None, c=None):
    """(color, specular) with the diffuse/full switch of training: diffuse
    only (specular zero) until full_flag (JAX network.rgb_train)."""
    gf = geo_feat(params, x, spec, max_level, c)
    diffuse = gf[..., :3]
    specular = _specular(params, d, gf, spec)
    if full_flag:
        return (diffuse + specular).clamp(0.0, 1.0), specular
    return diffuse, torch.zeros_like(specular)


_FD_SIGNS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
             (0, 0, -1))


def finite_diff_normal(params: NeRFField, x: torch.Tensor, spec: NetworkSpec,
                       epsilon: float = 1e-4,
                       max_level: Optional[int] = None) -> torch.Tensor:
    """Central-difference gradient of the SDF [N, 3] (JAX
    network.finite_diff_normal): the 6 taps x +- epsilon along each axis,
    clipped to the bound, go through ONE density call of 6N points, so the
    splat path sorts them once."""
    b = spec.bound
    offsets = torch.tensor(_FD_SIGNS, dtype=torch.float32,
                           device=x.device) * epsilon
    xs = (x[None, :, :] + offsets[:, None, :]).clamp(-b, b)      # [6, N, 3]
    vals = density(params, xs.reshape(-1, 3), spec, max_level).reshape(6, -1)
    return torch.stack([0.5 * (vals[0] - vals[1]) / epsilon,
                        0.5 * (vals[2] - vals[3]) / epsilon,
                        0.5 * (vals[4] - vals[5]) / epsilon], dim=-1)


def sdf_pretrain_loss(params: NeRFField, xyzs: torch.Tensor,
                      spec: NetworkSpec, r1: float = 0.5,
                      r2: float = 1.5) -> torch.Tensor:
    """Double-sphere SDF target at the points xyzs [N, 3] (JAX
    network.sdf_pretrain_loss, which draws them itself): the distance to
    the nearer of the spheres of radius r1 (inside) and r2 (outside), mean
    squared error."""
    d = torch.linalg.norm(xyzs, dim=-1)
    gt = torch.where(d < (r1 + r2) / 2, d - r1, r2 - d)
    return ((density(params, xyzs, spec) - gt) ** 2).mean()
