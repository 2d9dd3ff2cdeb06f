"""zarr v2 arrays on an OCDBT or plain-directory store (utils/ocdbt.py).

An array ``name`` is its metadata ``name/.zarray`` (JSON: shape, chunks,
dtype, order, fill_value, compressor, filters, dimension_separator) and one
value a chunk, ``name/i.j.k`` (``name/0`` for a scalar, whose chunks are
``[]``).  ``read_array`` reads what tensorstore writes for Orbax: the
numeric and bool dtypes of numpy in either byte order and ``bfloat16``
(returned as float32, exactly), scalars and any number of chunks, order C
or F, absent chunks as fill_value, compressor ``zstd`` or none.
``encode_array`` encodes what Orbax writes for a numpy leaf: one chunk
the size of the array, zstd (the port's raw/RLE frames), order C,
fill_value null.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np

from . import zstd


def _dtype(s: str):
    """(numpy dtype of the stored elements, bfloat16?)"""
    if s == "bfloat16":
        return np.dtype("<u2"), True
    dt = np.dtype(s)
    if dt.kind not in "biufc":
        raise NotImplementedError(f"zarr dtype {s!r} is not read")
    return dt, False


def _fill(value, dt: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


def _decode(raw: np.ndarray, compressor) -> np.ndarray:
    if compressor is None:
        return raw
    if compressor.get("id") == "zstd":
        return zstd.decompress_array(raw)
    raise NotImplementedError(
        f"zarr compressor {compressor.get('id')!r} is not read (only zstd "
        "and none)")


def read_array(store, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store` as a numpy array."""
    meta = json.loads(store.get(name + "/.zarray").tobytes())
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise NotImplementedError(f"{name}: zarr filters are not read")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    dt, bf16 = _dtype(meta["dtype"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    per = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    key = f"{name}/{sep.join('0' for _ in shape) if shape else '0'}"
    if chunks == shape and order == "C" and key in store:
        # one chunk the size of the array (what Orbax writes): no copy
        raw = _decode(store.get(key), meta.get("compressor"))
        if raw.size != per:
            raise ValueError(f"{key}: {raw.size} bytes, not {per}")
        return _native(raw.view(dt).reshape(shape), bf16)
    out = np.full(shape, _fill(meta.get("fill_value"), dt), dt)
    for idx in itertools.product(*[range(g) for g in grid]):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = _decode(store.get(key), meta.get("compressor"))
        if raw.size != per:
            raise ValueError(f"{key}: {raw.size} bytes, not {per}")
        chunk = raw.view(dt).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, x.stop - x.start) for x in sl)]
    return _native(out, bf16)


def _native(a: np.ndarray, bf16: bool) -> np.ndarray:
    if bf16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(a.dtype.newbyteorder("="), copy=False)


def encode_array(arr) -> list:
    """numpy array `arr` as a zarr v2 array of one chunk: its values under
    the array's name, [(".zarray", metadata), (chunk key, zstd frame)]
    (no chunk for an empty array)."""
    arr = np.require(arr, requirements="C")      # keeps a 0-d array 0-d
    if arr.dtype.kind not in "biufc":
        raise ValueError(f"dtype {arr.dtype} is not written")
    shape = list(arr.shape)
    meta = {"chunks": [max(s, 1) for s in shape],
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": arr.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    out = [(".zarray", json.dumps(meta, sort_keys=True,
                                  separators=(",", ":")).encode())]
    if arr.size:
        key = ".".join("0" for _ in shape) if shape else "0"
        out.append((key, zstd.compress_array(arr)))
    return out
