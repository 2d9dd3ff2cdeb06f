"""Orbax PyTree checkpoints (the JAX trainer's ``.ocp`` directories) without
orbax, JAX, tensorstore or zstandard.

What ``ocp.PyTreeCheckpointer().save(path, tree)`` of orbax-checkpoint
0.11 writes, and what this module reads and writes:

* ``_METADATA`` (JSON): ``tree_metadata``, one entry a leaf, keyed by
  ``str`` of its key path as a tuple of strings, with ``key_metadata``
  (each key and its type: 1 a sequence index, 2 a dict key or NamedTuple
  field) and ``value_metadata`` (``{"value_type": "np.ndarray",
  "skip_deserialize": false}`` for an array; an empty NamedTuple such as
  optax's ``MaskedNode`` is a leaf ``{"value_type": "None",
  "skip_deserialize": true}`` with no data); ``use_ocdbt``, ``use_zarr3``,
  ``store_array_data_equal_to_fill_value``, ``custom_metadata``.
* ``_CHECKPOINT_METADATA`` (JSON): the handler's name and timestamps.
* the arrays: zarr v2, or zarr v3 under ``use_zarr3`` (utils/zarr.py
  reads both), each named by its key path joined
  with dots (``params.table``, ``opt_state.inner_states.base.inner_state.
  0.mu.table``, ``step``), in an OCDBT database (``use_ocdbt``, Orbax's
  default; utils/ocdbt.py) or one directory an array.

``save_pytree`` writes the OCDBT layout, as the JAX trainer does (without
Orbax's per-process ``ocdbt.process_0/`` database, which Orbax's own
restore does not read), its arrays zarr v2 as the JAX trainer writes;
``load_pytree`` reads either layout with either zarr version.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .ocdbt import DirStore, OcdbtStore, OcdbtWriter
from .zarr import encode_array, read_array

SEQUENCE, DICT = 1, 2
HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
           "PyTreeCheckpointHandler")
MASKED = None          # the leaf value of an empty NamedTuple

Path = Tuple[Tuple[str, int], ...]


def flatten(tree: Any, fields: Dict[str, tuple],
            path: Path = ()) -> List[Tuple[Path, Any]]:
    """JAX's flatten order with Orbax's key types: dicts by sorted key,
    lists and tuples by index, records (objects with ``name`` and
    ``fields``, e.g. convert._JaxRecord) by their field names from
    `fields`; a record without fields is a MASKED leaf; anything else is an
    array leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], fields, path + ((str(k), DICT),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, fields, path + ((str(i), SEQUENCE),))
        return out
    if hasattr(tree, "fields") and hasattr(tree, "name"):
        names = fields[tree.name]
        if not names:
            return [(path, MASKED)]
        out = []
        for n, v in zip(names, tree.fields):
            out += flatten(v, fields, path + ((n, DICT),))
        return out
    return [(path, tree)]


def save_pytree(path: str, leaves: List[Tuple[Path, Any]],
                files: Optional[Dict[str, bytes]] = None) -> None:
    """Writes the checkpoint directory `path` (replacing it) from
    flattened (key path, leaf) pairs, plus `files` (name -> bytes) in it;
    the directory appears whole or not at all."""
    t0 = time.time_ns()
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    writer = OcdbtWriter(tmp)
    tree_metadata = {}
    arrays = [(keys, leaf) for keys, leaf in leaves if leaf is not MASKED]
    # the arrays encode in parallel (the codec runs without the GIL) and
    # are written in order as they come
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        encoded = pool.map(lambda a: encode_array(np.asarray(a[1])), arrays)
        for (keys, _), values in zip(arrays, encoded):
            for suffix, data in values:
                writer.put(".".join(k for k, _ in keys) + "/" + suffix, data)
    writer.close()
    for keys, leaf in leaves:
        value = ({"value_type": "None", "skip_deserialize": True}
                 if leaf is MASKED else
                 {"value_type": "np.ndarray", "skip_deserialize": False})
        tree_metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value}
    meta = {"tree_metadata": tree_metadata, "use_ocdbt": True,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    out = {"_METADATA": json.dumps(meta).encode()}
    out.update(files or {})
    out["_CHECKPOINT_METADATA"] = json.dumps({
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}).encode()
    for name, data in out.items():
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(data)
    _replace(tmp, path)


def copy_checkpoint(src: str, dst: str) -> None:
    """Replace `dst` by a copy of the checkpoint directory `src`, whole or
    not at all (the trainer's _latest copy: the same files, copied by the
    kernel, in place of a second encode)."""
    tmp = f"{dst}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(src, tmp)
    _replace(tmp, dst)


def _replace(tmp: str, path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)
    os.replace(tmp, path)


def load_pytree(path: str) -> Dict[Tuple[str, ...], np.ndarray]:
    """An Orbax PyTree checkpoint directory -> {key path: array} for every
    leaf that has data (MaskedNode and other skipped leaves have none)."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise ValueError(f"{path}: _METADATA without tree_metadata (an "
                         "Orbax checkpoint from before 0.5 is not read)")
    store = (OcdbtStore(path) if meta.get("use_ocdbt", True)
             else DirStore(path))
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        vm = entry.get("value_metadata", {})
        if not (vm.get("skip_deserialize") or vm.get("value_type") == "None"):
            leaves.append(keys)
    # the arrays decode in parallel: the codec runs without the GIL
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        arrays = pool.map(lambda k: read_array(store, ".".join(k)), leaves)
        return dict(zip(leaves, arrays))
