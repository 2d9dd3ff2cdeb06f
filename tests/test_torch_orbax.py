"""Orbax checkpoints (.ocp) in the port without orbax, tensorstore, zstandard
or JAX, held to those libraries on the CPU (utils/ocdbt.py, utils/zarr.py,
utils/orbax.py, the trainer's ckpt_backend "orbax").

* OCDBT: the port reads a tensorstore database of 500 keys written with
  small nodes (a B+tree of height >= 1, values inline and in data files),
  and tensorstore reads the port's at three node sizes.
* Checkpoints: a JAX Trainer's .ocp loads into the port with every leaf
  equal and the step and optimizer carried; the port's .ocp loads into
  JAX's Trainer fully matched (no partial restore) and equals the same
  state written as a pickle; stage 1 both ways; schema drift gives the
  partial restore and its WARN on both sides; Orbax's one-directory-an-
  array layout; the pickle backend's auto-detect; a resume from .ocp that
  trains on bit-equal to one from .ckpt; the rolling window of 2.
* zarr3 (Orbax's use_zarr3): trees with multi-chunk, bfloat16 and 0-d
  leaves in both layouts read as orbax restores them; tensorstore's
  absent inner chunks, big-endian bytes under a transpose, a shard index
  at the start, v2 keys and a bool scalar as tensorstore reads them; a
  corrupt shard index and an unknown codec are refused.  The port's calls
  run with orbax, tensorstore, zstandard and PIL blocked in sys.modules.
* The committed JAX fixtures (nerf2mesh_tpu_torch/fixtures/jax_stage0.ocp,
  written by ``python tests/test_torch_orbax.py``, and its zarr3 twin
  jax_stage0_zarr3.ocp, by ``python tests/test_torch_orbax.py zarr3``):
  their leaf hashes equal JAX's restore and the port's read, and the v2
  one's zstd frames hold compressed blocks with Huffman literals and
  FSE-coded sequences.
"""

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "nerf2mesh_tpu_torch" / "fixtures"
OCP_FIXTURE = FIXTURES / "jax_stage0.ocp"
OCP_HASHES = FIXTURES / "jax_stage0.json"
OCP3_FIXTURE = FIXTURES / "jax_stage0_zarr3.ocp"
OCP3_HASHES = FIXTURES / "jax_stage0_zarr3.json"
BLOCKED = ("orbax", "tensorstore", "zstandard", "PIL")
SCENE = dict(H=32, W=32, n_train=4, n_val=1, n_test=0)
TINY = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=256,
            num_points=4096, grid_size=32, num_levels=6, log2_hashmap_size=14,
            grid_layout="ref", random_image_batch=True, background="random",
            mark_untrained=True, diffuse_step=1000, steps_per_dispatch=1,
            stochastic_fine=False)
# the fixture's trainer: the JAX package's own orbax test configuration, its
# tables and grid cut (2^9 rows a level, 16^3) to keep the files small
FIXTURE_CONFIG = dict(grid_size=16, num_levels=4, log2_hashmap_size=9,
                      num_rays=256, num_points=4096, bound=1.0, scale=0.8,
                      dt_gamma=0.0, random_image_batch=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def blocked(*names):
    """Run the port as on a machine without these packages."""
    names = names or BLOCKED
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] in names}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n in names:
            del sys.modules[n]
        sys.modules.update(saved)


def jax_mods():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from nerf2mesh_tpu.config import Config
    from nerf2mesh_tpu.data.provider import load_nerf_dataset
    from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset
    from nerf2mesh_tpu.utils import trainer
    return Config, load_nerf_dataset, generate_synthetic_dataset, trainer


def tiny(cls, root, ws, **kw):
    return dataclasses.replace(cls(path=root), **{**TINY, "workspace": ws,
                                                  **kw}).finalize()


def jax_leaves(state):
    """{dotted key path: numpy leaf} of a JAX TrainState, Orbax's names."""
    import jax
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = []
        for k in path:
            for attr in ("name", "key", "idx"):
                if hasattr(k, attr):
                    names.append(str(getattr(k, attr)))
                    break
        out[".".join(names)] = np.asarray(v)
    return out


def port_leaves(trainer):
    """The same names from a port trainer (its JAX TrainState, the PRNG key
    left out: the port keeps none)."""
    from nerf2mesh_tpu_torch.utils import orbax
    from nerf2mesh_tpu_torch.utils.convert import _RECORD_FIELDS, jax_state
    return {".".join(k for k, _ in keys): np.asarray(v)
            for keys, v in orbax.flatten(jax_state(trainer._payload()),
                                         _RECORD_FIELDS)
            if v is not orbax.MASKED and keys[0][0] != "key"}


def assert_leaves_equal(got, want, skip=("key",)):
    names = [k for k in want if k.split(".")[0] not in skip]
    assert set(names) <= set(got), sorted(set(names) - set(got))
    for k in names:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def sha(a: np.ndarray) -> dict:
    a = np.asarray(a)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


# ------------------------------------------------------------------ OCDBT
def test_ocdbt_reads_tensorstore_and_tensorstore_reads_it(tmp_path):
    import tensorstore as ts
    from nerf2mesh_tpu_torch.utils import ocdbt
    rng = np.random.default_rng(0)
    vals = {b"k/%04d.%s" % (i, b"x" * (i % 7)): rng.integers(
        0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
        for i in range(500)}
    base = tmp_path / "ts"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{base}/",
                          "config": {"max_decoded_node_bytes": 2000,
                                     "max_inline_value_bytes": 100}}).result()
    with ts.Transaction() as txn:
        for k, v in vals.items():
            kv.with_transaction(txn).write(k, v).result()
    with blocked():
        st = ocdbt.OcdbtStore(str(base))
        assert st.height >= 1
        assert st.keys() == sorted(vals)
        for k, v in vals.items():
            assert st.get(k).tobytes() == v, k
    out = tmp_path / "port"
    with blocked():
        w = ocdbt.OcdbtWriter(str(out))
        for k, v in vals.items():
            w.put(k, v)
        w.close()
        assert ocdbt.OcdbtStore(str(out)).height == 0
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{out}/"}).result()
    assert sorted(kv.list().result()) == sorted(vals)
    for k, v in vals.items():
        assert kv.read(k).result().value == v, k


def test_ocdbt_refuses_corrupt_files(tmp_path, monkeypatch):
    from nerf2mesh_tpu_torch.utils import ocdbt
    w = ocdbt.OcdbtWriter(str(tmp_path / "db"))
    w.put("a", b"x" * 2000)
    w.close()
    man = tmp_path / "db" / "manifest.ocdbt"
    data = bytearray(man.read_bytes())
    data[20] ^= 1
    man.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtStore(str(tmp_path / "db"))
    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", 2000)
    w = ocdbt.OcdbtWriter(str(tmp_path / "big"))
    for i in range(100):
        w.put(f"key/{i:04d}", b"v" * 100)
    with pytest.raises(ValueError, match="leaf of"):
        w.close()


def test_zarr_reads_chunked_fortran_and_filled_arrays(tmp_path):
    import tensorstore as ts
    from nerf2mesh_tpu_torch.utils import ocdbt, zarr
    rng = np.random.default_rng(1)
    cases = {"f": (rng.standard_normal((7, 5)).astype("<f4"), "F", [3, 2]),
             "i": (rng.integers(-9, 9, (9, 4, 3)).astype("<i4"), "C",
                   [4, 4, 2]),
             "b": (rng.random((6,)) > 0.5, "C", [4]),
             "s": (np.asarray(7, np.uint32), "C", [])}
    for name, (a, order, chunks) in cases.items():
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                            "path": name},
                "metadata": {"shape": list(a.shape), "chunks": chunks,
                             "dtype": a.dtype.str, "order": order,
                             "compressor": {"id": "zstd", "level": 3},
                             "fill_value": None if name != "i" else 5},
                "create": True}
        t = ts.open(spec).result()
        if name == "i":          # one chunk never written: fill_value
            t[:4].write(a[:4]).result()
            a = a.copy()
            a[4:] = 5
        else:
            t.write(a).result()
    with blocked():
        st = ocdbt.OcdbtStore(str(tmp_path))
        for name, (a, _, _) in cases.items():
            got = zarr.read_array(st, name)
            want = a.copy() if name != "i" else np.concatenate(
                [a[:4], np.full_like(a[4:], 5)])
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=name)


# ------------------------------------------------------------ checkpoints
@pytest.fixture(scope="module")
def jax_ocp(tmp_path_factory):
    """A JAX trainer at the ref layout after 2 steps and its .ocp."""
    JConfig, jload, jgen, jtr = jax_mods()
    d = tmp_path_factory.mktemp("jax_ocp")
    root, ws = str(d / "scene"), str(d / "ws")
    jgen(root, **SCENE)
    jt = jtr.Trainer(tiny(JConfig, root, ws, ckpt_backend="orbax"))
    jds = jload(jt.cfg, "train")
    jt.mark_untrained(jds)
    jt.train_steps(jds, 2)
    jt.save_checkpoint()
    return jt, root, ws


def test_jax_ocp_loads_into_the_port(jax_ocp):
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    jt, root, ws = jax_ocp
    logs = []
    with blocked():
        t = Trainer(tiny(Config, root, ws), device="cpu")
        t.log = logs.append
        assert t.load_checkpoint()          # a pickle trainer finds the .ocp
        got = port_leaves(t)
    assert not any("partial" in m for m in logs), logs
    want = jax_leaves(jt.state)
    assert_leaves_equal(got, want)
    assert t.step == 2 and t.ema_count == int(jt.state.ema_count)
    st = t.optimizer.state[t.params.table]
    assert int(st["step"]) == 2 and st["exp_avg"].abs().sum() > 0
    assert t.num_rays == jt.num_rays


def test_port_ocp_loads_into_jax_as_its_pickle_does(tmp_path):
    JConfig, jload, jgen, jtr = jax_mods()
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.utils.convert import write_jax_checkpoint
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    root = str(tmp_path / "scene")
    jgen(root, **SCENE)
    with blocked():
        t = Trainer(tiny(Config, root, str(tmp_path / "o"),
                         ckpt_backend="orbax"), device="cpu")
        ds = load_nerf_dataset(t.cfg, "train")
        t.mark_untrained(ds)
        t.train_steps(ds, 3)
        path = t.save_checkpoint()
        pickled = tmp_path / "p" / "checkpoints" / "ngp_stage0_latest.ckpt"
        pickled.parent.mkdir(parents=True)
        write_jax_checkpoint(t._payload(), str(pickled))
    assert path.endswith("ngp_stage0_0000003.ocp") and os.path.isdir(path)
    states = []
    for ws in ("o", "p"):
        jt = jtr.Trainer(tiny(JConfig, root, str(tmp_path / ws),
                              ckpt_backend="orbax"))
        logs = []
        jt.log = logs.append
        assert jt.load_checkpoint()
        assert not any("partial" in m or "WARN" in m for m in logs), logs
        assert int(jt.state.step) == 3
        states.append(jax_leaves(jt.state))
    assert_leaves_equal(states[0], states[1], skip=())
    assert_leaves_equal(states[0], port_leaves(t), skip=("key",))


def test_schema_drift_is_a_partial_restore_on_both_sides(jax_ocp, tmp_path):
    JConfig, _, _, jtr = jax_mods()
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    jt, root, ws = jax_ocp
    ocp = os.path.join(ws, "checkpoints", "ngp_stage0_latest.ocp")
    logs = []
    with blocked():
        t = Trainer(tiny(Config, root, str(tmp_path / "t"),
                         log2_hashmap_size=13), device="cpu")
        table = t.params.table.detach().clone()
        t.log = logs.append
        assert t.load_checkpoint(ocp)
    assert any("orbax checkpoint schema drift: partial restore" in m
               for m in logs), logs
    assert t.step == 0 and torch.equal(t.params.table, table)
    np.testing.assert_array_equal(
        t.params.sigma_net[0].w.detach().numpy(),
        np.asarray(jt.state.params["sigma_net"][0]["w"]))
    # the port's .ocp into a drifted JAX trainer
    t2 = Trainer(tiny(Config, root, str(tmp_path / "o"),
                      ckpt_backend="orbax"), device="cpu")
    t2.step = 5
    with blocked():
        t2.save_checkpoint()
    jd = jtr.Trainer(tiny(JConfig, root, str(tmp_path / "o"),
                          ckpt_backend="orbax", log2_hashmap_size=13))
    jlogs = []
    jd.log = jlogs.append
    assert jd.load_checkpoint()
    assert any("partial restore" in m for m in jlogs), jlogs
    assert int(jd.state.step) == 0


def test_orbax_directory_layout_loads(jax_ocp, tmp_path):
    """Orbax's one-directory-an-array layout (use_ocdbt=False)."""
    import jax
    import orbax.checkpoint as ocp
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    jt, root, ws = jax_ocp
    path = tmp_path / "ws" / "checkpoints" / "ngp_stage0_latest.ocp"
    path.parent.mkdir(parents=True)
    state = jax.tree_util.tree_map(np.asarray, jt.state)
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)) as c:
        c.save(str(path), state)
    shutil.copy(os.path.join(ws, "checkpoints", "ngp_stage0_latest.ocp",
                             "n2m_meta.json"), path / "n2m_meta.json")
    assert not (path / "manifest.ocdbt").exists()
    with blocked():
        t = Trainer(tiny(Config, root, str(tmp_path / "ws")), device="cpu")
        assert t.load_checkpoint()
        got = port_leaves(t)
    assert_leaves_equal(got, jax_leaves(jt.state))
    assert t.step == 2


def test_ocp_resume_trains_on_as_the_pickle_resume_does(tmp_path):
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    root = generate_synthetic_dataset(str(tmp_path / "scene"), **SCENE)
    cfg = tiny(Config, root, str(tmp_path / "a"), adaptive_num_rays=True,
               stochastic_fine=True)
    ds = load_nerf_dataset(cfg, "train")
    with blocked():
        a = Trainer(cfg, device="cpu")
        a.mark_untrained(ds)
        a.train_steps(ds, 3)
        a.save_checkpoint()
        a.cfg = dataclasses.replace(cfg, ckpt_backend="orbax")
        a.workspace = str(tmp_path / "b")
        a.save_checkpoint()
        runs = []
        for ws, backend in (("a", "pickle"), ("b", "orbax")):
            t = Trainer(dataclasses.replace(cfg, ckpt_backend=backend,
                                            workspace=str(tmp_path / ws)),
                        device="cpu")
            assert t.load_checkpoint()
            losses = [float(t.train_steps(ds, 1)["loss"]) for _ in range(2)]
            runs.append((losses, port_leaves(t)))
    assert runs[0][0] == runs[1][0]
    assert_leaves_equal(runs[1][1], runs[0][1], skip=())


def test_rolling_window_keeps_two_ocp_checkpoints(tmp_path):
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    cfg = tiny(Config, "", str(tmp_path), ckpt_backend="orbax",
               num_levels=4, log2_hashmap_size=10)
    t = Trainer(cfg, device="cpu")
    with blocked():
        for step in (1, 2, 3):
            t.step = step
            t.save_checkpoint()
    cdir = tmp_path / "checkpoints"
    assert sorted(os.listdir(cdir)) == [
        "ngp_stage0_0000002.ocp", "ngp_stage0_0000003.ocp",
        "ngp_stage0_latest.ocp"]
    assert all((cdir / p).is_dir() for p in os.listdir(cdir))


def zarr3_tree():
    """A tree with a leaf of 4 chunks, a bfloat16 leaf, 0-d leaves and
    integer and bool leaves, and the save_args that chunk the first."""
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    rng = np.random.default_rng(0)
    tree = {"multi": rng.standard_normal((10, 100)).astype(np.float32),
            "bf16": jnp.asarray(rng.standard_normal(37), jnp.bfloat16),
            "step": np.int32(7), "scale": np.float64(0.25),
            "u8": rng.integers(0, 256, (3, 5, 2)).astype(np.uint8),
            "mask": rng.random(9) < 0.5,
            "nested": {"a": [np.arange(6, dtype=np.int64),
                             np.float32(np.nan)]}}
    args = jax_tree_map(lambda _: ocp.SaveArgs(), tree)
    args["multi"] = ocp.SaveArgs(chunk_byte_size=1024)
    return tree, args


def jax_tree_map(fn, tree):
    import jax
    return jax.tree_util.tree_map(fn, tree)


@pytest.mark.parametrize("use_ocdbt", [True, False])
def test_zarr3_trees_read_bit_equal(tmp_path, use_ocdbt):
    """Orbax's zarr3 layout (use_zarr3), in an OCDBT database and one
    directory an array: every leaf as orbax restores it, bit for bit."""
    import orbax.checkpoint as ocp
    from nerf2mesh_tpu_torch.utils import ocdbt, orbax
    tree, args = zarr3_tree()
    path = str(tmp_path / "z3.ocp")
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
            use_zarr3=True, use_ocdbt=use_ocdbt)) as c:
        c.save(path, args=ocp.args.PyTreeSave(tree, save_args=args))
        want = jax_leaves(c.restore(path))
    store = (ocdbt.OcdbtStore(path) if use_ocdbt else ocdbt.DirStore(path))
    assert len([k for k in store.keys()
                if k.startswith(b"multi/c/")]) == 4
    assert b"step/c" in store.keys()
    with blocked():
        got = {".".join(k): v for k, v in orbax.load_pytree(path).items()}
    assert set(got) == set(want)
    saved = jax_leaves(tree)
    for k, w in want.items():
        # orbax restores a 0-d leaf as a Python scalar: held in the saved
        # leaf's dtype, and bfloat16 widened exactly, as the port returns it
        dt = np.asarray(saved[k]).dtype
        w = np.asarray(w).astype(np.float32 if dt.name == "bfloat16" else dt)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def _shard(inner, codecs, where="end"):
    return [{"name": "sharding_indexed", "configuration": {
        "chunk_shape": inner, "codecs": codecs, "index_location": where,
        "index_codecs": [{"name": "bytes",
                          "configuration": {"endian": "little"}},
                         {"name": "crc32c"}]}}]


LE = {"name": "bytes", "configuration": {"endian": "little"}}
ZSTD = {"name": "zstd", "configuration": {"level": 3, "checksum": False}}
# name: (codecs, shape, chunk shape, data type, fill value, the region
# written, key encoding)
ZARR3_CASES = {
    "absent_inner_chunks": (_shard([4, 4], [LE, ZSTD]), [16, 12], [16, 12],
                            "float32", "NaN", (slice(0, 4), slice(0, 8)),
                            "default"),
    "big_endian_transposed": (
        [{"name": "transpose", "configuration": {"order": [1, 0]}},
         {"name": "bytes", "configuration": {"endian": "big"}},
         {"name": "zstd", "configuration": {"level": 1}}],
        [7, 9], [4, 4], "int16", 5, (slice(0, 7), slice(0, 9)), "default"),
    "index_at_start_bf16": (_shard([2], [LE, {"name": "crc32c"}], "start"),
                            [11], [6], "bfloat16", "Infinity",
                            (slice(0, 5),), "default"),
    "v2_keys": ([LE], [5, 3], [2, 2], "uint8", 0, (slice(0, 5), slice(0, 3)),
                "v2"),
    "bool_scalar": ([{"name": "bytes"}], [], [], "bool", True, (), "default"),
}


@pytest.mark.parametrize("case", sorted(ZARR3_CASES))
def test_zarr3_codecs_read_bit_equal(tmp_path, case):
    """tensorstore's zarr3 driver writes what Orbax does not: inner chunks
    left absent (fill_value), big-endian bytes under a transpose, the shard
    index at the start, the v2 key encoding, a bool scalar; the port reads
    each as tensorstore does."""
    import tensorstore as ts
    from nerf2mesh_tpu_torch.utils import ocdbt, zarr
    codecs, shape, chunk, dtype, fill, region, keys = ZARR3_CASES[case]
    t = ts.open({
        "driver": "zarr3", "create": True,
        "kvstore": {"driver": "file", "path": str(tmp_path / case)},
        "metadata": {"shape": shape, "data_type": dtype, "codecs": codecs,
                     "fill_value": fill, "chunk_key_encoding": {"name": keys},
                     "chunk_grid": {"name": "regular",
                                    "configuration": {"chunk_shape": chunk}}},
    }).result()
    rng = np.random.default_rng(1)
    part = rng.integers(-999, 999, [s.stop - s.start for s in region])
    t[region].write(part.astype(t.dtype.numpy_dtype)
                    if dtype != "bool" else False).result()
    want = np.asarray(t.read().result())
    if dtype == "bfloat16":
        want = want.astype(np.float32)
    store = ocdbt.DirStore(str(tmp_path))
    with blocked():
        got = zarr.read_array(store, case)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "absent_inner_chunks":
        index = store.get(f"{case}/c/0/0")[-4 - 16 * 12:-4].view("<u8")
        assert (index == 2 ** 64 - 1).sum() == 2 * 10      # 10 of 12 absent
        assert np.isnan(got[4:]).all() and not np.isnan(got[:4, :8]).any()


def test_zarr3_checkpoints_are_refused(tmp_path):
    """A zarr3 checkpoint that is corrupt or uses a codec the port does not
    read is refused: a shard index whose CRC-32C does not match raises
    ValueError, an unknown codec NotImplementedError naming ROADMAP A6 (h);
    the untouched checkpoint loads."""
    import orbax.checkpoint as ocp
    from nerf2mesh_tpu_torch.utils import orbax
    tree, args = zarr3_tree()
    path = tmp_path / "z3.ocp"
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
            use_zarr3=True, use_ocdbt=False)) as c:
        c.save(str(path), args=ocp.args.PyTreeSave(tree, save_args=args))
    with blocked():
        assert orbax.load_pytree(str(path))[("step",)] == 7
        shard = path / "multi" / "c" / "0" / "1"
        data = bytearray(shard.read_bytes())
        data[-10] ^= 1                          # a bit of the index
        shard.write_bytes(bytes(data))
        with pytest.raises(ValueError, match="crc32c mismatch"):
            orbax.load_pytree(str(path))
        data[-10] ^= 1
        shard.write_bytes(bytes(data))
        meta = json.loads((path / "u8" / "zarr.json").read_text())
        inner = meta["codecs"][0]["configuration"]["codecs"]
        inner[-1] = {"name": "blosc", "configuration": {"cname": "lz4"}}
        (path / "u8" / "zarr.json").write_text(json.dumps(meta))
        with pytest.raises(NotImplementedError, match=r"'blosc'.*A6 \(h\)"):
            orbax.load_pytree(str(path))


# ---------------------------------------------------------------- stage 1
def stage1_workspace(tmp_path):
    from test_torch_cli import stage1_workspace as make
    jcfg, tcfg = make(tmp_path)
    return (dataclasses.replace(jcfg, ckpt_backend="orbax"),
            dataclasses.replace(tcfg, ckpt_backend="orbax"))


def test_stage1_ocp_both_ways(tmp_path):
    import jax.numpy as jnp
    import optax.tree_utils as otu
    JConfig, jload, _, jtr = jax_mods()
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    jcfg, tcfg = stage1_workspace(tmp_path)
    jt = jtr.Trainer(jcfg)
    jt.setup_stage1(jload(jcfg, "train"))
    rng = np.random.default_rng(0)
    offs = jt.state.params["vertices_offsets"]
    offs = jnp.asarray(0.01 * rng.standard_normal(offs.shape), jnp.float32)
    params = dict(jt.state.params, vertices_offsets=offs)
    jt.state = jt.state._replace(
        params=params, ema_params=params, step=jnp.asarray(5, jnp.int32),
        opt_state=otu.tree_set(jt.state.opt_state,
                               count=jnp.asarray(5, jnp.int32)))
    jt.save_checkpoint()
    with blocked():
        t = Trainer(tcfg, device="cpu")
        t.setup_stage1(load_nerf_dataset(tcfg, "train"))
        assert t.load_checkpoint()
        got = port_leaves(t)
    assert_leaves_equal(got, jax_leaves(jt.state))
    assert t.step == 5
    assert int(t.optimizer.state[t.vertices_offsets]["step"]) == 5

    # the port's stage-1 .ocp (new offsets and moments) back into JAX
    with torch.no_grad():
        t.vertices_offsets.add_(0.01)
    t.step = 7
    st = t.optimizer.state[t.vertices_offsets]
    st["exp_avg"] = torch.rand(tuple(t.vertices_offsets.shape))
    with blocked():
        t.save_checkpoint()
    jt2 = jtr.Trainer(jcfg)
    jt2.setup_stage1(jload(jcfg, "train"))
    logs = []
    jt2.log = logs.append
    assert jt2.load_checkpoint()
    assert not any("WARN" in m for m in logs), logs
    assert int(jt2.state.step) == 7
    assert_leaves_equal(jax_leaves(jt2.state), port_leaves(t), skip=())


# ---------------------------------------------------------------- fixture
def write_fixture(out_dir: Path = FIXTURES) -> None:
    """Writes the JAX fixture: a JAX Trainer at FIXTURE_CONFIG after 3
    steps on a 32^2 scene, saved by Orbax as jax_stage0.ocp, and
    jax_stage0.json with the config and each leaf's SHA-256 (of its bytes
    as JAX holds them), dtype and shape."""
    import tempfile
    import jax
    import orbax.checkpoint as ocp
    JConfig, jload, jgen, jtr = jax_mods()
    tmp = tempfile.mkdtemp()
    root, ws = os.path.join(tmp, "scene"), os.path.join(tmp, "ws")
    jgen(root, **SCENE)
    cfg = dataclasses.replace(JConfig(path=root), workspace=ws,
                              ckpt_backend="orbax",
                              **FIXTURE_CONFIG).finalize()
    jt = jtr.Trainer(cfg)
    ds = jload(cfg, "train")
    jt.mark_untrained(ds)
    jt.train_steps(ds, 3)
    jt.save_checkpoint()
    src = os.path.join(ws, "checkpoints", "ngp_stage0_latest.ocp")
    dst = out_dir / "jax_stage0.ocp"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    with ocp.PyTreeCheckpointer() as c:
        raw = c.restore(str(dst))
    leaves = jax_leaves(jax.tree_util.tree_map(np.asarray, jt.state))
    assert set(leaves) <= set(jax_leaves(raw))
    OCP_HASHES.write_text(json.dumps(
        {"config": FIXTURE_CONFIG, "steps": 3,
         "leaves": {k: sha(v) for k, v in leaves.items()}}, indent=1) + "\n")
    shutil.rmtree(tmp)


def write_zarr3_fixture(out_dir: Path = FIXTURES) -> None:
    """Writes jax_stage0_zarr3.ocp: the fixture's 3-step JAX state (the
    same trainer, scene and steps as write_fixture) saved by the JAX
    trainer through Orbax's PyTreeCheckpointHandler(use_zarr3=True), and
    jax_stage0_zarr3.json with the config and each leaf's SHA-256."""
    import tempfile
    import jax
    import orbax.checkpoint as ocp
    JConfig, jload, jgen, jtr = jax_mods()
    tmp = tempfile.mkdtemp()
    root, ws = os.path.join(tmp, "scene"), os.path.join(tmp, "ws")
    jgen(root, **SCENE)
    cfg = dataclasses.replace(JConfig(path=root), workspace=ws,
                              ckpt_backend="orbax",
                              **FIXTURE_CONFIG).finalize()
    jt = jtr.Trainer(cfg)
    ds = jload(cfg, "train")
    jt.mark_untrained(ds)
    jt.train_steps(ds, 3)
    plain = ocp.PyTreeCheckpointer
    ocp.PyTreeCheckpointer = lambda: ocp.Checkpointer(
        ocp.PyTreeCheckpointHandler(use_zarr3=True))
    try:
        jt.save_checkpoint()
    finally:
        ocp.PyTreeCheckpointer = plain
    src = os.path.join(ws, "checkpoints", "ngp_stage0_latest.ocp")
    assert json.loads(Path(src, "_METADATA").read_text())["use_zarr3"]
    dst = out_dir / "jax_stage0_zarr3.ocp"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    leaves = jax_leaves(jax.tree_util.tree_map(np.asarray, jt.state))
    OCP3_HASHES.write_text(json.dumps(
        {"config": FIXTURE_CONFIG, "steps": 3,
         "leaves": {k: sha(v) for k, v in leaves.items()}}, indent=1) + "\n")
    shutil.rmtree(tmp)


def zstd_block_kinds(data: bytes) -> dict:
    """Counts of the zstd block kinds in a stream of frames: raw, rle,
    compressed, and among the compressed the Huffman-coded literals and
    the FSE-coded sequence tables (any of the three fields in mode 2)."""
    out = dict(raw=0, rle=0, compressed=0, huffman=0, fse=0)
    pos = 0
    while pos < len(data):
        (magic,) = struct.unpack("<I", data[pos:pos + 4])
        assert magic == 0xFD2FB528
        fhd = data[pos + 4]
        fcs = {0: 1 if fhd & 32 else 0, 1: 2, 2: 4, 3: 8}[fhd >> 6]
        pos += 5 + (0 if fhd & 32 else 1) + [0, 1, 2, 4][fhd & 3] + fcs
        while True:
            (h,) = struct.unpack("<I", data[pos:pos + 3] + b"\0")
            last, kind, size = h & 1, (h >> 1) & 3, h >> 3
            b = data[pos + 3:pos + 3 + (1 if kind == 1 else size)]
            pos += 3 + len(b)
            out[("raw", "rle", "compressed")[kind]] += 1
            if kind == 2:
                lt, sf = b[0] & 3, (b[0] >> 2) & 3
                if lt < 2:
                    hdr = (1, 2, 1, 3)[sf]
                    reg = (b[0] >> 3 if sf in (0, 2) else
                           (b[0] >> 4) + (b[1] << 4) if sf == 1 else
                           (b[0] >> 4) + (b[1] << 4) + (b[2] << 12))
                    lsize = hdr + (reg if lt == 0 else 1)
                else:
                    out["huffman"] += 1
                    hdr = (3, 3, 4, 5)[sf]
                    v = int.from_bytes(b[:hdr], "little")
                    lsize = hdr + ((v >> 14) & 0x3FF if sf < 2 else
                                   (v >> 18) & 0x3FFF if sf == 2 else
                                   (v >> 22) & 0x3FFFF)
                n = b[lsize]
                if n:
                    skip = 1 if n < 128 else 2 if n < 255 else 3
                    modes = b[lsize + skip]
                    if 2 in (modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3):
                        out["fse"] += 1
            if last:
                break
        pos += 4 if fhd & 4 else 0
    return out


def test_committed_jax_fixture(tmp_path):
    import orbax.checkpoint as ocp
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils import ocdbt
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    want = json.loads(OCP_HASHES.read_text())
    with ocp.PyTreeCheckpointer() as c:
        raw = c.restore(str(OCP_FIXTURE))
    jl = jax_leaves(raw)
    for k, h in want["leaves"].items():
        a = np.asarray(jl[k]).reshape(h["shape"])
        assert sha(a) == h, k
    kinds = dict(raw=0, rle=0, compressed=0, huffman=0, fse=0)
    st = ocdbt.OcdbtStore(str(OCP_FIXTURE))
    for key in st.keys():
        if not key.endswith(b".zarray"):
            for k, v in zstd_block_kinds(st.get(key).tobytes()).items():
                kinds[k] += v
    assert kinds["compressed"] and kinds["huffman"] and kinds["fse"], kinds
    cfg = dataclasses.replace(Config(), workspace=str(tmp_path),
                              **want["config"]).finalize()
    with blocked():
        t = Trainer(cfg, device="cpu")
        assert t.load_checkpoint(str(OCP_FIXTURE))
        got = port_leaves(t)
    assert t.step == want["steps"]
    for k, h in want["leaves"].items():
        if k != "key":
            assert sha(got[k]) == h, k


def test_committed_jax_zarr3_fixture(tmp_path):
    """The JAX trainer's 3-step state through Orbax's zarr3 handler: orbax
    restores the hashes in its JSON (the v2 fixture's, the same state), and
    the port's Trainer loads every leaf bit-equal to orbax's restore."""
    import orbax.checkpoint as ocp
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils import ocdbt
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    want = json.loads(OCP3_HASHES.read_text())
    assert want["leaves"] == json.loads(OCP_HASHES.read_text())["leaves"]
    assert json.loads((OCP3_FIXTURE / "_METADATA").read_text())["use_zarr3"]
    with ocp.PyTreeCheckpointer() as c:
        raw = jax_leaves(c.restore(str(OCP3_FIXTURE)))
    st = ocdbt.OcdbtStore(str(OCP3_FIXTURE))
    metas = [json.loads(st.get(k).tobytes()) for k in st.keys()
             if k.endswith(b"/zarr.json")]
    assert len(metas) == len(raw) and all(
        m["codecs"][0]["name"] == "sharding_indexed" and
        m["codecs"][0]["configuration"]["index_codecs"][-1]["name"] ==
        "crc32c" for m in metas)
    cfg = dataclasses.replace(Config(), workspace=str(tmp_path),
                              **want["config"]).finalize()
    with blocked():
        t = Trainer(cfg, device="cpu")
        assert t.load_checkpoint(str(OCP3_FIXTURE))
        got = port_leaves(t)
    assert t.step == want["steps"]
    for k, h in want["leaves"].items():
        if k != "key":
            assert sha(got[k]) == h, k
            r = np.asarray(raw[k]).reshape(h["shape"])
            assert got[k].dtype == r.dtype and got[k].tobytes() == \
                r.tobytes(), k


def test_port_reads_the_fixtures_with_the_libraries_blocked(tmp_path):
    """In a process where jax, orbax, tensorstore, zstandard, PIL and the
    JAX package cannot be imported: the JAX fixtures (zarr v2 and v3) load
    into a Trainer
    (its leaves hash as JAX's did), a progressive JPEG and a 16-bit
    interlaced PNG decode, and none of those modules was imported."""
    import subprocess
    want = json.loads(OCP_HASHES.read_text())
    code = f"""
import sys
for m in ("jax", "jaxlib", "optax", "nerf2mesh_tpu", "orbax", "tensorstore",
          "zstandard", "PIL"):
    sys.modules[m] = None
import dataclasses, hashlib, json
import numpy as np
from nerf2mesh_tpu_torch.config import Config
from nerf2mesh_tpu_torch.data.png import read_image
from nerf2mesh_tpu_torch.utils import orbax
from nerf2mesh_tpu_torch.utils.convert import _RECORD_FIELDS, jax_state
from nerf2mesh_tpu_torch.utils.trainer import Trainer
cfg = dataclasses.replace(Config(), workspace={str(tmp_path)!r},
                          **{want["config"]!r}).finalize()
want = json.load(open({str(OCP_HASHES)!r}))["leaves"]
for path in ({str(OCP_FIXTURE)!r}, {str(OCP3_FIXTURE)!r}):
    t = Trainer(cfg, device="cpu")
    assert t.load_checkpoint(path)
    for keys, v in orbax.flatten(jax_state(t._payload()), _RECORD_FIELDS):
        name = ".".join(k for k, _ in keys)
        if v is not orbax.MASKED and name != "key":
            h = hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            assert h == want[name]["sha256"], (path, name)
assert read_image({str(FIXTURES / "progressive" / "train" / "r_0.jpg")!r}
                  ).shape == (256, 256, 3)
assert read_image({str(FIXTURES / "png" / "rgba16_adam7.png")!r}
                  ).shape == (24, 32, 4)
mods = [k for k in sys.modules if k.split(".")[0] in ("nerf2mesh_tpu",
        "jax", "jaxlib", "optax", "orbax", "tensorstore", "zstandard",
        "PIL") and sys.modules[k] is not None]
assert not mods, mods
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout + res.stderr


if __name__ == "__main__":
    if sys.argv[1:] == ["zarr3"]:
        write_zarr3_fixture()
    else:
        write_fixture()
