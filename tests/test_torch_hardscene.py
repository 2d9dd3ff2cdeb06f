"""The port's copy of the hard proxy scene (data/synthetic.py HardScene)
against the JAX package's, on the CPU: the ray tracer and the SDF within
1e-6 (the same numpy code; equal in practice), and a 48x48 dataset written
by each generator with byte-equal PNGs and equal transforms."""

import json
import os

import numpy as np

from nerf2mesh_tpu.data import synthetic as jsyn
from nerf2mesh_tpu_torch.data import synthetic as tsyn
from nerf2mesh_tpu_torch.data.png import read_image


def rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 2.8 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o      # towards the scene
    return o.astype(np.float32), d.astype(np.float32)


def test_hard_scene_trace_and_sdf_match_jax():
    js, ts = jsyn.HardScene(), tsyn.HardScene()
    for attr in ("boxes", "rods"):
        for a, b in zip(getattr(js, attr), getattr(ts, attr)):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    o, d = rays(4096, 0)
    rgb_j, a_j = js.trace(o, d)
    rgb_t, a_t = ts.trace(o, d)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(a_t, a_j)
    assert 0.1 < a_t.mean() < 0.9 and rgb_t[a_t > 0].std() > 0.05
    pts = np.random.default_rng(1).uniform(-0.8, 0.8, (20000, 3)).astype(
        np.float32)
    np.testing.assert_allclose(ts.sdf(pts), js.sdf(pts), atol=1e-6, rtol=0)
    # another seed draws other rods, in both packages alike
    o2 = jsyn.HardScene(seed=3).trace(o, d)[0]
    np.testing.assert_allclose(tsyn.HardScene(seed=3).trace(o, d)[0], o2,
                               atol=1e-6, rtol=0)


def test_hard_scene_dataset_is_byte_equal(tmp_path):
    kw = dict(H=48, W=48, n_train=3, n_val=2, n_test=1)
    jroot = jsyn.generate_synthetic_dataset(str(tmp_path / "jax"),
                                            scene=jsyn.HardScene(), **kw)
    troot = tsyn.generate_synthetic_dataset(str(tmp_path / "port"),
                                            scene=tsyn.HardScene(), **kw)
    frames = tsyn.render_synthetic_frames(tsyn.HardScene(), **kw)
    for split, n in (("train", 3), ("val", 2), ("test", 1)):
        with open(os.path.join(jroot, f"transforms_{split}.json")) as f:
            jt = json.load(f)
        with open(os.path.join(troot, f"transforms_{split}.json")) as f:
            tt = json.load(f)
        assert tt == jt
        for k in range(n):
            rel = f"{split}/r_{k}.png"
            with open(os.path.join(jroot, rel), "rb") as f:
                jbytes = f.read()
            with open(os.path.join(troot, rel), "rb") as f:
                assert f.read() == jbytes, rel
            np.testing.assert_array_equal(
                read_image(os.path.join(troot, rel)),
                frames[split]["images"][k])
    alpha = frames["train"]["images"][..., 3] / 255.0
    assert 0.05 < alpha.mean() < 0.6      # the JAX provider test's coverage
