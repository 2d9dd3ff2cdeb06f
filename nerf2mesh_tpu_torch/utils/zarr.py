"""zarr v2 and v3 arrays on an OCDBT or plain-directory store
(utils/ocdbt.py).

zarr v2: an array ``name`` is its metadata ``name/.zarray`` (JSON: shape,
chunks, dtype, order, fill_value, compressor, filters,
dimension_separator) and one value a chunk, ``name/i.j.k`` (``name/0`` for
a scalar, whose chunks are ``[]``).  ``read_array`` reads what tensorstore
writes for Orbax: the numeric and bool dtypes of numpy in either byte
order and ``bfloat16`` (returned as float32, exactly), scalars and any
number of chunks, order C or F, absent chunks as fill_value, compressor
``zstd`` or none.

zarr v3 (Orbax's ``use_zarr3``): the metadata is ``name/zarr.json``
(shape, data_type, chunk_grid, chunk_key_encoding, codecs, fill_value)
and a chunk's key is ``name/c/i/j`` (``name/c`` for a scalar) under the
``default`` encoding or ``name/i.j`` (``name/0``) under ``v2``.
``read_array`` reads the ``regular`` chunk grid and the codecs
``transpose``, ``bytes`` (either endianness), ``zstd``, ``crc32c``
(checked: a mismatch raises ValueError) and ``sharding_indexed``, which
Orbax writes around every chunk: its inner chunks, each through its own
codecs, and an index of (offset, size) pairs at the shard's end or start
(``index_location``), through the index codecs; a pair of 2^64-1 marks an
absent inner chunk, which holds fill_value (a number, ``NaN``,
``Infinity``, ``-Infinity`` or the raw bits as ``0x...``).  Any other
codec raises NotImplementedError.

``encode_array`` encodes what Orbax writes for a numpy leaf by default
(zarr v2, as the JAX trainer writes): one chunk the size of the array,
zstd (the port's raw/RLE frames), order C, fill_value null.
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
    """The zarr v2 or v3 array `name` of `store` as a numpy array."""
    if name + "/zarr.json" in store:
        return _read_v3(store, name)
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


# zarr v3 data types: the numpy type of their elements (bfloat16: its bits)
_V3_TYPES = {"bool": "?", "int8": "i1", "int16": "i2", "int32": "i4",
             "int64": "i8", "uint8": "u1", "uint16": "u2", "uint32": "u4",
             "uint64": "u8", "float16": "f2", "float32": "f4",
             "float64": "f8", "complex64": "c8", "complex128": "c16",
             "bfloat16": "u2"}
_ABSENT = np.uint64(2 ** 64 - 1)


def _unsupported(name: str, what: str):
    return NotImplementedError(f"{name}: zarr v3 {what} is not read "
                               "(ROADMAP A6 (h))")


def _fill_v3(value, type_name: str, dt: np.dtype):
    """A v3 fill_value as a scalar of the stored type (bfloat16: its bits)."""
    if isinstance(value, str) and value.startswith("0x"):
        bits = int(value, 16)                     # the raw bits
        return np.array(bits, f"u{dt.itemsize}").view(dt)[()]
    if isinstance(value, list):                   # complex: [re, im]
        value = complex(*[_fill(v, dt) for v in value])
    else:
        value = _fill(value, dt)
    if type_name == "bfloat16":
        return np.uint16(np.array(value, np.float32).view(np.uint32) >> 16)
    return np.array(value).astype(dt)[()]


def _read_v3(store, name: str) -> np.ndarray:
    meta = json.loads(store.get(name + "/zarr.json").tobytes())
    if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
        raise ValueError(f"{name}: zarr.json is not a zarr v3 array")
    shape = tuple(meta["shape"])
    grid = meta["chunk_grid"]
    if grid.get("name") != "regular":
        raise _unsupported(name, f"chunk grid {grid.get('name')!r}")
    chunks = tuple(grid["configuration"]["chunk_shape"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    type_name = meta["data_type"]
    if type_name not in _V3_TYPES:
        raise _unsupported(name, f"data type {type_name!r}")
    dt = np.dtype(_V3_TYPES[type_name])
    fill = _fill_v3(meta.get("fill_value"), type_name, dt)
    enc = meta.get("chunk_key_encoding", {"name": "default"})
    sep = enc.get("configuration", {}).get(
        "separator", "/" if enc.get("name") == "default" else ".")
    if enc.get("name") == "default":
        def key(idx):
            return sep.join([f"{name}/c", *map(str, idx)])
    elif enc.get("name") == "v2":
        def key(idx):
            return f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
    else:
        raise _unsupported(name, f"chunk key encoding {enc.get('name')!r}")
    codecs = meta["codecs"]
    grid_n = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    if chunks == shape and key((0,) * len(shape)) in store:
        # one chunk the size of the array (what Orbax writes): no copy
        out = _decode_chunk(store.get(key((0,) * len(shape))), codecs,
                            chunks, dt, fill, name)
        return _native(out, type_name == "bfloat16")
    out = np.full(shape, fill, dt)
    for idx in itertools.product(*[range(g) for g in grid_n]):
        k = key(idx)
        if k not in store:
            continue
        chunk = _decode_chunk(store.get(k), codecs, chunks, dt, fill, name)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, x.stop - x.start) for x in sl)]
    return _native(out, type_name == "bfloat16")


def _decode_chunk(raw: np.ndarray, codecs, shape: tuple, dt: np.dtype,
                  fill, name: str) -> np.ndarray:
    """One chunk's bytes through its v3 codec chain, in reverse: the
    bytes-to-bytes codecs, the array-to-bytes codec, then the
    array-to-array codecs; an array of `shape` (in dt's byte order or the
    native one)."""
    kinds = [c["name"] for c in codecs]
    n_aa = 0
    while n_aa < len(kinds) and kinds[n_aa] == "transpose":
        n_aa += 1
    if n_aa == len(kinds) or kinds[n_aa] not in ("bytes", "sharding_indexed"):
        raise _unsupported(name, f"codec chain {kinds}")
    enc_shape = tuple(shape)
    orders = []
    for c in codecs[:n_aa]:
        order = c["configuration"]["order"]
        if order == "C":
            order = list(range(len(enc_shape)))
        elif order == "F":
            order = list(range(len(enc_shape)))[::-1]
        orders.append(order)
        enc_shape = tuple(enc_shape[o] for o in order)
    for c in reversed(codecs[n_aa + 1:]):
        if c["name"] == "zstd":
            raw = zstd.decompress_array(raw)
        elif c["name"] == "crc32c":
            if raw.size < 4:
                raise ValueError(f"{name}: crc32c codec on {raw.size} bytes")
            want = int(raw[-4:].view("<u4")[0])
            raw = raw[:-4]
            if zstd.crc32c(raw) != want:
                raise ValueError(f"{name}: crc32c mismatch")
        else:
            raise _unsupported(name, f"codec {c['name']!r}")
    ab = codecs[n_aa]
    conf = ab.get("configuration", {})
    if ab["name"] == "bytes":
        endian = conf.get("endian", "little")
        if endian not in ("little", "big"):
            raise _unsupported(name, f"bytes endian {endian!r}")
        cdt = dt.newbyteorder("<" if endian == "little" else ">")
        n = int(np.prod(enc_shape, dtype=np.int64)) * dt.itemsize
        if raw.size != n:
            raise ValueError(f"{name}: chunk of {raw.size} bytes, not {n}")
        arr = np.ascontiguousarray(raw).view(cdt).reshape(enc_shape)
    else:
        arr = _read_shard(raw, conf, enc_shape, dt, fill, name)
    for order in reversed(orders):
        arr = arr.transpose(np.argsort(order))
    return arr


def _read_shard(raw: np.ndarray, conf: dict, shape: tuple, dt: np.dtype,
                fill, name: str) -> np.ndarray:
    inner = tuple(conf["chunk_shape"])
    if len(inner) != len(shape) or any(
            c < 1 or s % c for s, c in zip(shape, inner)):
        raise ValueError(f"{name}: inner chunks {inner} for a shard "
                         f"{shape}")
    n_inner = tuple(s // c for s, c in zip(shape, inner))
    n = int(np.prod(n_inner, dtype=np.int64))
    index_codecs = conf.get("index_codecs", [{"name": "bytes"},
                                             {"name": "crc32c"}])
    size = 16 * n + 4 * sum(c["name"] == "crc32c" for c in index_codecs)
    if raw.size < size:
        raise ValueError(f"{name}: shard of {raw.size} bytes, its index "
                         f"{size}")
    where = conf.get("index_location", "end")
    if where not in ("end", "start"):
        raise _unsupported(name, f"index_location {where!r}")
    index = _decode_chunk(raw[raw.size - size:] if where == "end" else
                          raw[:size], index_codecs, n_inner + (2,),
                          np.dtype("u8"), 0, name)
    out = np.full(shape, fill, dt)
    for idx in itertools.product(*[range(g) for g in n_inner]):
        off, nb = index[idx]
        if off == _ABSENT and nb == _ABSENT:
            continue
        off, nb = int(off), int(nb)
        if off + nb > raw.size:
            raise ValueError(f"{name}: inner chunk {idx} at {off}+{nb} "
                             f"past the shard's {raw.size} bytes")
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, inner))
        out[sl] = _decode_chunk(raw[off:off + nb], conf["codecs"], inner,
                                dt, fill, name)
    return out


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
