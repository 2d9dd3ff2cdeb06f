"""State carry-over between the JAX package and the port.

The JAX params are a nested dict/list pytree (nerf2mesh_tpu/models/
network.py init_network): ``{"table": [total, 3], "sigma_net": [{"w":
[in, out]}, ...], ...}``, with ``sigma_table`` [total, 1] and
``color_table`` [total, 2] in place of ``table`` under separate tables.
The port's ``NeRFField`` names the same arrays ``table`` (or
``sigma_table``, ``color_table``) and ``sigma_net.0.w``: the flattened
pytree path, Adam's moments included.  Layouts are
identical, so conversion is a rename and a copy.  The occupancy state
(the JAX ``RenderState``) carries over the same way
(``render_state_from_jax``), and so do whole checkpoints of either stage:
``read_jax_checkpoint`` reads a JAX one without JAX (the stage-1 ``vert``
label's moments included), ``write_jax_checkpoint`` writes a port payload
as one the JAX package loads; ``read_orbax_checkpoint`` and
``write_orbax_checkpoint`` do the same for the Orbax ``.ocp`` directories
of ``--ckpt_backend orbax`` (utils/orbax.py).
"""

from __future__ import annotations

import json
import os
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


def params_to_numpy(named: Dict[str, torch.Tensor],
                    shapes_only: bool = False) -> Dict[str, Any]:
    """{name: tensor} (e.g. dict(module.named_parameters())) -> the JAX
    pytree layout with numpy leaves; numeric path parts become list items.
    shapes_only: each leaf a read-only zero of the tensor's shape and dtype
    that holds no memory (a template for matching shapes)."""
    tree: Dict[str, Any] = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = (np.broadcast_to(np.zeros((), str(t.dtype)[6:]),
                                      tuple(t.shape)) if shapes_only
                      else t.detach().cpu().numpy())
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
    "ScaleByScheduleState": ("count",),
    "PartitionState": ("inner_states",),
    "MaskedState": ("inner_state",),
    "MaskedNode": (),
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


# ------------------------------------------------------- port -> JAX pickle

# Where the classes of a JAX format-2 checkpoint live: the JAX package's
# records and optax's (optax 0.2: nerf2mesh_tpu/utils/trainer.py
# make_optimizer is a partition over the labels base / slow / vert, each
# label an Adam masked to its parameters).
_JAX_CLASSES = {
    "TrainState": "nerf2mesh_tpu.utils.trainer",
    "RenderState": "nerf2mesh_tpu.models.renderer",
    "PartitionState": "optax.transforms._combining",
    "MaskedState": "optax.transforms._masking",
    "MaskedNode": "optax.transforms._masking",
    "ScaleByAdamState": "optax._src.transform",
    "ScaleByScheduleState": "optax._src.transform",
}
_SLOW_PARAMS = ("individual_codes", "variance")


class _JaxRecord:
    """A record to pickle as a call of the JAX-side class `name` on
    `fields` (a NamedTuple built from its fields in order)."""

    def __init__(self, name: str, *fields):
        self.name, self.fields = name, fields

    def __reduce__(self):
        return _jax_class(self.name), self.fields


@lru_cache(maxsize=None)
def _jax_class(name: str) -> type:
    """A stand-in class pickled by reference as the JAX side's class."""
    return type(name, (), {"__module__": _JAX_CLASSES[name],
                           "_jax_ref": True})


class _JaxPickler(pickle._Pickler):
    """Writes the stand-in classes as references to their JAX-side modules
    without importing them (the pure-Python pickler lets a subclass write
    a global; the C one imports the module to check it)."""

    def save_global(self, obj, name=None):
        if not getattr(obj, "_jax_ref", False):
            return super().save_global(obj, name)
        self.save(obj.__module__)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def param_label(name: str) -> str:
    """The JAX optimizer's label of a parameter: "vert" (the stage-1
    offsets), "slow" (0.1x the lr) or "base"."""
    if name == "vertices_offsets":
        return "vert"
    return "slow" if name in _SLOW_PARAMS else "base"


def jax_state(payload: Dict[str, Any], seed: int = 0) -> _JaxRecord:
    """The port payload's plain state -> the JAX TrainState records: the
    Adam moments split over the optimizer's labels (the other labels'
    leaves MaskedNode), one shared count, the PRNG key of `seed` (the port
    keeps no JAX key)."""
    st = payload["state"]
    opt = st["opt_state"]
    count = np.asarray(opt["count"], np.int32)
    inner = {}
    for label in ("base", "slow", "vert"):
        def part(tree):
            return {k: (v if param_label(k) == label else _JaxRecord("MaskedNode"))
                    for k, v in tree.items()}
        adam = _JaxRecord("ScaleByAdamState", count, part(opt["mu"]),
                          part(opt["nu"]))
        inner[label] = _JaxRecord(
            "MaskedState", (adam, _JaxRecord("ScaleByScheduleState", count)))
    r = st["render"]
    render = _JaxRecord(
        "RenderState", np.asarray(r["density_grid"], np.float32),
        np.asarray(r["occ_grid"]), np.asarray(r["mean_density"], np.float32),
        np.asarray(r["iter_density"], np.int32))
    return _JaxRecord(
        "TrainState", st["params"], _JaxRecord("PartitionState", inner),
        st["ema_params"], np.asarray(st["ema_count"], np.int32), render,
        np.asarray(st["step"], np.int32), np.asarray([0, seed], np.uint32))


def write_jax_checkpoint(payload: Dict[str, Any], path: str,
                         seed: int = 0) -> None:
    """Write a port checkpoint payload (Trainer._payload, or a port .ckpt
    read back with read_jax_checkpoint) as a format-2 checkpoint that the
    JAX package's Trainer.load_checkpoint restores: its TrainState, RenderState
    and optax records by reference, the rest as plain data.  Imports neither
    JAX nor optax."""
    out = {k: v for k, v in payload.items()
           if k not in ("state", "framework", "rng")}
    out["state"] = jax_state(payload, seed)
    with open(path, "wb") as f:
        _JaxPickler(f, protocol=4).dump(out)


# ------------------------------------------------------- Orbax checkpoints

_LABELS = ("base", "slow", "vert")


def write_orbax_checkpoint(payload: Dict[str, Any], path: str,
                           seed: int = 0) -> None:
    """Write a port checkpoint payload as the JAX trainer's Orbax
    checkpoint directory (nerf2mesh_tpu/utils/trainer.py _save_orbax): the
    TrainState tree of ``jax_state`` through utils/orbax.py, and
    ``n2m_meta.json`` with the payload's other keys, the port's generator
    states among them as JSON lists (JAX's loader ignores them)."""
    from . import orbax
    leaves = orbax.flatten(jax_state(payload, seed), _RECORD_FIELDS)
    meta = {k: v for k, v in payload.items()
            if k not in ("state", "framework", "rng")}
    rng = payload.get("rng")
    if rng is not None:
        meta["rng"] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in rng.items()}
    files = {"n2m_meta.json": json.dumps(meta, default=float).encode()}
    orbax.save_pytree(path, leaves, files)


def read_orbax_checkpoint(path: str, live: Dict[str, Any],
                          seed: int = 0) -> Dict[str, Any]:
    """Read an Orbax checkpoint directory of either package into the plain
    payload of ``read_jax_checkpoint``, with JAX's ``_tree_from_raw``
    semantics: the leaves of `live` (the loading trainer's own payload, as
    a TrainState; its parameters and moments may be shape-only templates,
    ``Trainer._payload(shapes_only=True)``) are matched by key path, and
    one that the checkpoint lacks or holds in another shape makes the
    restore partial (``payload["partial"]``) and keeps the live value: a
    parameter, EMA or moment leaf is left out of the payload, so that the
    trainer's non-strict merge keeps its own; any other takes `live`'s."""
    from . import orbax
    raw = orbax.load_pytree(path)
    got, ok = {}, True
    for keys, leaf in orbax.flatten(jax_state(live, seed), _RECORD_FIELDS):
        if leaf is orbax.MASKED:
            continue
        names = tuple(k for k, _ in keys)
        r = raw.get(names)
        if r is None or r.shape != np.shape(leaf):
            ok = False
            if names[0] in ("params", "ema_params", "opt_state"):
                continue
            r = np.asarray(leaf)
        got[names] = r

    def sub(head, n):
        return {".".join(k[n:]): v for k, v in got.items()
                if k[:n] == head}
    mu, nu, count = {}, {}, 0
    for label in _LABELS:
        pre = ("opt_state", "inner_states", label, "inner_state", "0")
        m = sub(pre + ("mu",), 6)
        if m:                          # a partition with unmasked leaves
            mu.update(m)
            nu.update(sub(pre + ("nu",), 6))
            count = int(got.get(pre + ("count",), 0))
    payload = {"state": {
        "params": sub(("params",), 1), "ema_params": sub(("ema_params",), 1),
        "opt_state": {"count": count, "mu": mu, "nu": nu},
        "ema_count": int(got[("ema_count",)]), "step": int(got[("step",)]),
        "render": {k: got[("render", k)]
                   for k in _RECORD_FIELDS["RenderState"]},
        "key": got[("key",)]}, "partial": not ok}
    mpath = os.path.join(path, "n2m_meta.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            payload.update(json.load(f))
    rng = payload.get("rng")
    if rng is not None:
        payload["rng"] = {k: (np.asarray(v, np.uint8) if isinstance(v, list)
                              else v) for k, v in rng.items()}
    return payload
