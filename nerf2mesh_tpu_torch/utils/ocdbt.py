"""tensorstore's OCDBT key-value store, read and written without tensorstore.

An Orbax checkpoint directory is an OCDBT database (tensorstore's "OCDBT
on-disk format"): ``manifest.ocdbt`` holds the configuration and the
versions, each version names the root of a B+tree, and the tree's nodes
and the larger values live in data files under ``d/`` (or under another
directory of the database, such as ``ocdbt.process_0/d/``, which Orbax's
per-process databases write and its merged root manifest refers to).

Every manifest and node file is ``magic (uint32 big-endian) | length
(uint64) | format version (varint, 0) | compression (varint: 0 none, 1
zstd) | body | CRC-32C (uint32)`` over everything before the CRC; integers
are little-endian varints unless said otherwise, and the per-entry fields
are stored column by column.

* manifest body: uuid (16 bytes), manifest kind (0: versions inline),
  max_inline_value_bytes, max_decoded_node_bytes, version_tree_arity_log2
  (a byte), compression method (0 none; 1 zstd, then its level as int32);
  a data file table; the versions (generation, root height (a byte), root
  reference (file, offset, length), number of keys, tree bytes, indirect
  value bytes, commit time (uint64 ns)); the version-tree node references
  (generation, file, offset, length, number of generations, commit time,
  height) of versions older than the inline ones.
* data file table: n, then for files 1..n-1 the length of the prefix each
  path shares with the one before, the suffix lengths, the lengths of the
  base path (the path is base path + relative path, both under the
  database's root), and the suffixes.
* B+tree node body: height (a byte), a data file table, the entries.  A
  key is stored as the length of the prefix it shares with the key before
  and its suffix.  Leaf (height 0): value lengths, value kinds (0 inline,
  1 in a data file), the file and offset of each indirect value, then the
  inline values.  Interior: each child's first key and the length of the
  prefix shared by every key of its subtree (stripped from the keys inside
  it), the child node's reference (file, offset, length) and its subtree's
  number of keys, node bytes and indirect value bytes.

``OcdbtStore`` reads the newest version of a database (any tree height,
inline and indirect values, compressed or not, every CRC checked);
``OcdbtWriter`` writes one version the way tensorstore lays it out for a
tree of one leaf: the indirect values then the leaf in one data file
under ``d/``, the manifest last.
``DirStore`` reads the plain-directory store (one file per key) of
Orbax's non-OCDBT layout, with OcdbtStore's interface.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1

Bytes = Union[bytes, bytearray, memoryview, np.ndarray]


# ------------------------------------------------------------------ coding
class _Reader:
    def __init__(self, data: bytes, what: str):
        self.b, self.p, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"OCDBT {self.what}: {msg}")

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if self.p >= len(self.b):
                self.fail("truncated")
            c = self.b[self.p]
            self.p += 1
            v |= (c & 0x7F) << shift
            if c < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        return self.take(1)[0]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            self.fail("truncated")
        out = self.b[self.p:self.p + n]
        self.p += n
        return out


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _varints(vs: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in vs)


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """A manifest or node file -> its body, every check made."""
    if len(data) < 18:
        raise ValueError(f"OCDBT {what}: truncated")
    (m,) = struct.unpack(">I", data[:4])
    (length,) = struct.unpack("<Q", data[4:12])
    if m != magic:
        raise ValueError(f"OCDBT {what}: bad magic {m:#010x}")
    if length != len(data):
        raise ValueError(f"OCDBT {what}: length {length} != {len(data)}")
    (crc,) = struct.unpack("<I", data[-4:])
    if zstd.crc32c(data[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.p = 12
    if r.varint() != 0:
        r.fail("unknown format version")
    comp = r.varint()
    body = data[r.p:-4]
    if comp == 0:
        return bytes(body)
    if comp == 1:
        return zstd.decompress(body)
    r.fail(f"unknown compression {comp}")


def encode_file(body: bytes, magic: int, compress: bool) -> bytes:
    payload = zstd.compress(body, checksum=False) if compress else body
    head = _varint(0) + _varint(1 if compress else 0)
    length = 4 + 8 + len(head) + len(payload) + 4
    data = (struct.pack(">I", magic) + struct.pack("<Q", length) + head
            + payload)
    return data + struct.pack("<I", zstd.crc32c(data))


def _read_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    if n == 0:
        return []
    prefix = r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            r.fail("bad data file table")
        path = prev[:keep] + r.take(suffix[i])
        if base[i] > len(path):
            r.fail("bad data file table")
        paths.append(path.decode())
        prev = path
    return paths


def _file_table(paths: List[str]) -> bytes:
    """Data file table; every path is relative to the database root (base
    path empty), as tensorstore writes its own data files."""
    enc = [p.encode() for p in paths]
    prefix = [_common(enc[i - 1], enc[i]) for i in range(1, len(enc))]
    out = _varint(len(enc))
    if not enc:
        return out
    out += _varints(prefix)
    out += _varints(len(e) - ([0] + prefix)[i] for i, e in enumerate(enc))
    out += _varints(0 for _ in enc)
    return out + b"".join(e[([0] + prefix)[i]:] for i, e in enumerate(enc))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    return prefix, r.varints(n)


def _join_keys(r: _Reader, prefix: List[int], suffix: List[int]) -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            r.fail("bad key prefix")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys


# ------------------------------------------------------------------ reader
class OcdbtStore:
    """The newest version of the OCDBT database under `root`, read-only:
    ``keys()``, ``get(key)`` (a numpy uint8 array) and ``in``."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = decode_file(f.read(), MANIFEST_MAGIC, "manifest")
        r = _Reader(body, "manifest")
        self.uuid = r.take(16)
        kind = r.varint()
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.byte()
        self.compression = r.varint()
        if self.compression == 1:
            r.take(4)                    # zstd level
        elif self.compression != 0:
            r.fail(f"unknown compression method {self.compression}")
        if kind != 0:
            raise NotImplementedError(
                f"{root}: OCDBT numbered manifests (kind {kind}) are not "
                "read; Orbax writes single-file manifests")
        files = _read_file_table(r)
        n = r.varint()
        gens = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                 # keys, tree bytes, value bytes
        r.take(8 * n)                    # commit times
        m = r.varint()
        r.varints(5 * m)                 # generation, file, offset, length,
        r.take(8 * m)                    # generations, commit time,
        r.take(m)                        # height of older versions' nodes
        if r.p != len(body):
            r.fail("bytes after the versions")
        if not n:
            r.fail("no version")
        i = int(np.argmax(gens))
        self.generation, self.height = gens[i], heights[i]
        self._index: Dict[bytes, Tuple] = {}
        if off[i] != _MISSING:
            if fid[i] >= len(files):
                r.fail("root in an unknown data file")
            self._walk((files[fid[i]], off[i], length[i]), heights[i], b"")
        files = {ref[0] for ref in self._index.values() if len(ref) == 3}
        self._maps = {f: _map(os.path.join(root, f)) for f in files}

    def _read(self, ref: Tuple[str, int, int]) -> bytes:
        path, offset, length = ref
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} too short for "
                             f"{offset}+{length}")
        return data

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        body = decode_file(self._read(ref), NODE_MAGIC, "B+tree node")
        r = _Reader(body, "B+tree node")
        if r.byte() != height:
            r.fail("height differs from its reference")
        files = _read_file_table(r)
        n = r.varint()
        kp, ks = _keys(r, n)
        if height == 0:
            keys = _join_keys(r, kp, ks)
            lengths = r.varints(n)
            kinds = r.varints(n)
            k = sum(1 for v in kinds if v == 1)
            if any(v > 1 for v in kinds):
                r.fail("unknown value kind")
            vfid, voff = r.varints(k), r.varints(k)
            it = iter(range(k))
            for key, ln, kind in zip(keys, lengths, kinds):
                if kind:
                    j = next(it)
                    if vfid[j] >= len(files):
                        r.fail("value in an unknown data file")
                    self._index[prefix + key] = (files[vfid[j]], voff[j], ln)
                else:
                    self._index[prefix + key] = (r.take(ln),)
            if r.p != len(body):
                r.fail("bytes after the leaf's values")
            return
        common = r.varints(n)
        keys = _join_keys(r, kp, ks)
        cfid, coff, clen = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                 # subtree statistics
        if r.p != len(body):
            r.fail("bytes after the interior entries")
        for key, c, f, o, ln in zip(keys, common, cfid, coff, clen):
            if f >= len(files) or c > len(key):
                r.fail("bad child reference")
            self._walk((files[f], o, ln), height - 1, prefix + key[:c])

    def keys(self) -> List[bytes]:
        return sorted(self._index)

    def __contains__(self, key) -> bool:
        return _b(key) in self._index

    def get(self, key) -> np.ndarray:
        """The value (read-only): inline bytes, or a view of the data file
        mapped into memory (no copy of the file's pages)."""
        ref = self._index[_b(key)]
        if len(ref) == 1:
            return np.frombuffer(ref[0], np.uint8)
        path, offset, length = ref
        data = self._maps[path]
        if offset + length > data.size:
            raise ValueError(f"OCDBT: {path} too short for {offset}+{length}")
        return np.asarray(data[offset:offset + length])


def _map(path: str) -> np.ndarray:
    """A read-only view of the whole file mapped into memory: the values
    are decoded from the page cache with no copy of the file (reading it
    into memory first loads slower, workspace/port/ocp_walls.py)."""
    if os.path.getsize(path) == 0:
        return np.empty(0, np.uint8)
    return np.memmap(path, np.uint8, mode="r")


def _b(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


# ------------------------------------------------------------------ writer
# Orbax's settings for the databases it writes.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class OcdbtWriter:
    """Writes one version of a new OCDBT database under `root` (which must
    not hold one): ``put(key, value)`` any number of times, then
    ``close()``.  Values longer than MAX_INLINE_VALUE_BYTES go to the data
    file as they come; the tree, one zstd-compressed leaf, and the
    manifest are written at close.  A checkpoint's ~100 keys make a leaf
    of a few KB; one over MAX_DECODED_NODE_BYTES raises."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self.file = "d/" + os.urandom(16).hex()
        self._f = open(os.path.join(root, self.file), "wb")
        self._pos = 0
        self._values: Dict[bytes, Tuple] = {}

    def put(self, key, value: Bytes) -> None:
        key = _b(key)
        if isinstance(value, np.ndarray):
            data = memoryview(np.ascontiguousarray(value).reshape(-1)
                              .view(np.uint8))
        else:
            data = memoryview(value).cast("B")
        if len(data) <= MAX_INLINE_VALUE_BYTES:
            self._values[key] = (bytes(data),)
        else:
            self._f.write(data)
            self._values[key] = (self._pos, len(data))
            self._pos += len(data)

    def _leaf(self, keys: List[bytes]) -> bytes:
        vals = [self._values[k] for k in keys]
        ind = [v for v in vals if len(v) == 2]
        out = bytearray([0])
        out += _file_table([self.file] if ind else [])
        out += _varint(len(keys))
        out += _key_columns(keys)
        out += b"".join(_key_suffixes(keys))
        out += _varints(len(v[0]) if len(v) == 1 else v[1] for v in vals)
        out += _varints(0 if len(v) == 1 else 1 for v in vals)
        out += _varints(0 for _ in ind)
        out += _varints(v[0] for v in ind)
        out += b"".join(v[0] for v in vals if len(v) == 1)
        if len(out) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"OCDBT: a leaf of {len(out)} bytes is over "
                             f"{MAX_DECODED_NODE_BYTES}")
        return bytes(out)

    def close(self) -> None:
        keys = sorted(self._values)
        with self._f:
            if keys:
                leaf = encode_file(self._leaf(keys), NODE_MAGIC, True)
                self._f.write(leaf)
                vbytes = sum(v[1] for v in self._values.values()
                             if len(v) == 2)
                root = [0, self._pos, len(leaf), len(keys), len(leaf),
                        vbytes]
        body = bytearray(os.urandom(16))
        body += _varint(0)
        body += _varint(MAX_INLINE_VALUE_BYTES)
        body += _varint(MAX_DECODED_NODE_BYTES)
        body += bytes([VERSION_TREE_ARITY_LOG2])
        body += _varint(1) + struct.pack("<i", 0)      # zstd, default level
        if keys:
            body += _file_table([self.file])
        else:
            body += _file_table([""])
            root = [0, _MISSING, _MISSING, 0, 0, 0]
        body += _varint(1) + _varint(1) + bytes([0])   # generation 1, height 0
        body += _varints(root)
        body += struct.pack("<Q", time.time_ns())
        body += _varint(0)
        data = encode_file(bytes(body), MANIFEST_MAGIC, False)
        tmp = os.path.join(self.root, "manifest.ocdbt.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(self.root, "manifest.ocdbt"))


def _key_columns(rel: List[bytes]) -> bytes:
    prefix = [_common(rel[i - 1], rel[i]) for i in range(1, len(rel))]
    return _varints(prefix) + _varints(
        len(k) - ([0] + prefix)[i] for i, k in enumerate(rel))


def _key_suffixes(rel: List[bytes]) -> List[bytes]:
    out, prev = [], b""
    for k in rel:
        out.append(k[_common(prev, k):] if out else k)
        prev = k
    return out


# ------------------------------------------------------- plain directories
class DirStore:
    """Orbax's non-OCDBT layout: one file per key under `root`."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, key) -> str:
        return os.path.join(self.root, *_b(key).decode().split("/"))

    def keys(self) -> List[bytes]:
        out = []
        for d, _, files in os.walk(self.root):
            rel = os.path.relpath(d, self.root)
            for f in files:
                k = f if rel == "." else rel.replace(os.sep, "/") + "/" + f
                out.append(k.encode())
        return sorted(out)

    def __contains__(self, key) -> bool:
        return os.path.isfile(self._path(key))

    def get(self, key) -> np.ndarray:
        return np.fromfile(self._path(key), np.uint8)
