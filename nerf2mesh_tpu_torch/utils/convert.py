"""State carry-over between the JAX package and the port.

The JAX params are a nested dict/list pytree (nerf2mesh_tpu/models/
network.py init_network): ``{"table": [total, 3], "sigma_net": [{"w":
[in, out]}, ...], ...}``.  The port's ``NeRFField`` names the same arrays
``table`` and ``sigma_net.0.w``: the flattened pytree path.  Layouts are
identical, so conversion is a rename and a copy.  The occupancy state
(the JAX ``RenderState``) carries over the same way
(``render_state_from_jax``), and so do whole checkpoints
(``read_jax_checkpoint``).
"""

from __future__ import annotations

import pickle
from functools import lru_cache
from typing import Any, Dict

import numpy as np
import torch

from ..models.renderer import RenderState


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def flatten_params(tree: Any) -> Dict[str, np.ndarray]:
    """Pytree (dicts, lists, tuples) -> {dotted path: array}; an empty tuple
    (optax's MaskedNode) has no leaves."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return flat


def params_from_jax(np_tree: Any, device=None) -> Dict[str, torch.Tensor]:
    """JAX param pytree (arrays convertible by np.asarray) -> {name: tensor}."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(np_tree, "", flat)
    return {k: torch.tensor(np.array(v), device=device) for k, v in flat.items()}


def params_to_numpy(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{name: tensor} (e.g. dict(module.named_parameters())) -> the JAX
    pytree layout with numpy leaves; numeric path parts become list items."""
    tree: Dict[str, Any] = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return _listify(tree)


def _listify(node: Any) -> Any:
    """Dicts keyed "0".."n-1" become lists (the JAX MLP layer lists)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def load_params(module: torch.nn.Module, named: Dict[str, torch.Tensor]) -> None:
    """Copy {name: tensor} into the module's parameters (names and shapes
    must match exactly)."""
    own = dict(module.named_parameters())
    if set(own) != set(named):
        raise KeyError(f"parameter names differ: module {sorted(own)} vs "
                       f"given {sorted(named)}")
    with torch.no_grad():
        for k, p in own.items():
            src = named[k]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.device, p.dtype))


def render_state_from_jax(density_grid, occ_grid, mean_density, iter_density,
                          device=None) -> RenderState:
    """The JAX ``RenderState`` arrays (nerf2mesh_tpu/models/renderer.py:
    61-66; anything np.asarray takes) -> the port's RenderState: density
    grid [CAS, H, H, H] f32, uint8 occupancy of the same shape, scalar mean
    density, and the update count."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return RenderState(t(density_grid, torch.float32),
                       t(occ_grid, torch.uint8),
                       t(mean_density, torch.float32), int(iter_density))


# -------------------------------------------------------------- checkpoints

# Field order of the NamedTuples of a JAX format-2 checkpoint that are read
# by name: the package's TrainState and RenderState, and optax's Adam state
# (nerf2mesh_tpu/utils/trainer.py make_optimizer: a partition over adam,
# each partition a MaskedState of (ScaleByAdamState, ScaleByScheduleState)
# with MaskedNode leaves for the masked labels, walked as plain tuples).
_RECORD_FIELDS = {
    "TrainState": ("params", "opt_state", "ema_params", "ema_count",
                   "render", "step", "key"),
    "RenderState": ("density_grid", "occ_grid", "mean_density",
                    "iter_density"),
    "ScaleByAdamState": ("count", "mu", "nu"),
}
_FOREIGN_ROOTS = ("jax", "jaxlib", "optax", "nerf2mesh_tpu")


class _Record(tuple):
    """Plain stand-in for a NamedTuple of the JAX package or optax: the
    pickled fields, by position and (for the known classes) by name through
    ``field`` (attributes would collide with tuple's own, e.g. count)."""
    _fields: tuple = ()

    def __new__(cls, *args):
        return tuple.__new__(cls, args)

    def field(self, name):
        return self[self._fields.index(name)]


@lru_cache(maxsize=None)
def _record_class(name: str) -> type:
    return type(name, (_Record,), {"_fields": _RECORD_FIELDS.get(name, ())})


class _Unpickler(pickle.Unpickler):
    """Maps every class of JAX, optax and the JAX package to a stand-in, so
    a checkpoint reads without importing any of them."""

    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN_ROOTS:
            return _record_class(name)
        return super().find_class(module, name)


def _adam_states(node):
    if isinstance(node, _Record) and type(node).__name__ == "ScaleByAdamState":
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _adam_states(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _adam_states(v)


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """Read a format-2 pickle checkpoint (nerf2mesh_tpu/utils/trainer.py
    save_checkpoint, or the port's own) without JAX, optax or nerf2mesh_tpu.

    Returns the payload with its "state" as plain data: {"params",
    "ema_params": pytrees of numpy arrays; "opt_state": {"count", "mu",
    "nu"}: the Adam moments of every unmasked partition (the JAX optimizer
    is one Adam a label, and stage 0 has only the "base" label); "ema_count",
    "step"; "render": {density_grid, occ_grid, mean_density, iter_density};
    "key"}.  The port's checkpoints are written in that form already
    ("framework": "torch").  The JAX PRNG ``key`` has no counterpart in the
    port: after a resume from a JAX checkpoint the random stream differs."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("format") != 2:
        raise ValueError(f"{path}: checkpoint format "
                         f"{payload.get('format')!r}, not 2")
    if payload.get("framework") == "torch":
        return payload
    st = payload["state"]
    mu: Dict[str, np.ndarray] = {}
    nu: Dict[str, np.ndarray] = {}
    count = 0
    for adam in _adam_states(st.field("opt_state")):
        m = flatten_params(adam.field("mu"))
        if m:                          # a partition with unmasked leaves
            mu.update(m)
            nu.update(flatten_params(adam.field("nu")))
            count = int(adam.field("count"))
    r = st.field("render")
    payload = dict(payload)
    payload["state"] = {
        "params": st.field("params"), "ema_params": st.field("ema_params"),
        "opt_state": {"count": count, "mu": mu, "nu": nu},
        "ema_count": int(st.field("ema_count")), "step": int(st.field("step")),
        "render": {k: r.field(k) for k in _RECORD_FIELDS["RenderState"]},
        "key": np.asarray(st.field("key")),
    }
    return payload
