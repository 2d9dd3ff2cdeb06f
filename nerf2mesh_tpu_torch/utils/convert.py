"""Parameter carry-over between the JAX package's pytree and the port.

The JAX params are a nested dict/list pytree (nerf2mesh_tpu/models/
network.py init_network): ``{"table": [total, 3], "sigma_net": [{"w":
[in, out]}, ...], ...}``.  The port's ``NeRFField`` names the same arrays
``table`` and ``sigma_net.0.w``: the flattened pytree path.  Layouts are
identical, so conversion is a rename and a copy.  The occupancy state
(the JAX ``RenderState``) carries over the same way
(``render_state_from_jax``).
"""

from __future__ import annotations

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
