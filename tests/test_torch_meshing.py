"""The port's copies of the JAX package's host mesh code (meshing/io.py,
marching_cubes.py, meshops.py over native/meshops.cpp, uvatlas.py) give the
same arrays and bytes as the originals, on inputs made from a seed; the
C++ source is byte-equal, and the port builds its library (g++) into the
directory it is given, never beside the source."""

import os
from pathlib import Path

import numpy as np
import pytest

from nerf2mesh_tpu.meshing import io as jio
from nerf2mesh_tpu.meshing import marching_cubes as jmc
from nerf2mesh_tpu.meshing import meshops as jmo
from nerf2mesh_tpu.meshing import uvatlas as juv
from nerf2mesh_tpu_torch.meshing import io as tio
from nerf2mesh_tpu_torch.meshing import marching_cubes as tmc
from nerf2mesh_tpu_torch.meshing import meshops as tmo
from nerf2mesh_tpu_torch.meshing import uvatlas as tuv

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def port_lib(tmp_path_factory):
    """The port's library built into a tmp dir for this module."""
    d = tmp_path_factory.mktemp("meshops_build")
    old_dir, old_lib = tmo._BUILD_DIR, tmo._lib
    tmo._BUILD_DIR, tmo._lib = str(d), None
    yield d
    tmo._BUILD_DIR, tmo._lib = old_dir, old_lib


def blob_field(n=28, seed=0):
    """A smooth random field: a sum of gaussians on an n^3 grid."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    f = np.zeros_like(x)
    for c, s in zip(rng.uniform(-0.5, 0.5, (4, 3)), rng.uniform(0.2, 0.4, 4)):
        f += np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
                    / (2 * s * s))
    return f


@pytest.fixture(scope="module")
def mesh():
    v, f = jmc.marching_cubes(blob_field(), 0.5)
    return v / 27.0 * 2 - 1, f


def test_native_source_is_byte_equal():
    """Byte-equal but for the reference's path in the header comment, which
    the copy names without the original checkout's location."""
    a = (REPO / "nerf2mesh_tpu" / "native" / "meshops.cpp").read_bytes()
    b = (REPO / "nerf2mesh_tpu_torch" / "native" / "meshops.cpp").read_bytes()
    path = b"/" + b"/".join([b"root", b"reference", b"meshutils.py"])
    assert a.count(path) == 1
    assert a.replace(path, b"reference meshutils.py") == b


def test_library_builds_into_the_given_dir(port_lib):
    path = tmo.build()
    assert os.path.dirname(path) == str(port_lib) and os.path.exists(path)
    assert not list((REPO / "nerf2mesh_tpu_torch" / "native").glob("*.so"))
    assert tmo.library_path(str(port_lib)) == path


@pytest.mark.parametrize("level", [0.3, 0.5, 0.9])
def test_marching_cubes_equal(level):
    f = blob_field(20, seed=1)
    jv, jf = jmc.marching_cubes(f, level)
    tv, tf = tmc.marching_cubes(f, level)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert len(tf) > 0


def test_ply_and_obj_io_equal(mesh, tmp_path):
    v, f = mesh
    jio.write_ply(str(tmp_path / "j.ply"), v, f)
    tio.write_ply(str(tmp_path / "t.ply"), v, f)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    for a, b in zip(jio.read_ply(str(tmp_path / "j.ply")),
                    tio.read_ply(str(tmp_path / "j.ply"))):
        np.testing.assert_array_equal(a, b)
    vm, ft, vt = juv.unwrap_uv(v, f)
    for mod, name in ((jio, "j"), (tio, "t")):
        mod.write_obj(str(tmp_path / f"{name}.obj"), v, f, vts=vt, fts=ft,
                      mtl_name=f"{name}.mtl", tex_name="feat0_0.jpg")
    assert (tmp_path / "j.obj").read_text().replace("j.mtl", "x") == \
        (tmp_path / "t.obj").read_text().replace("t.mtl", "x")
    assert (tmp_path / "j.mtl").read_bytes() == (tmp_path / "t.mtl").read_bytes()


def test_unwrap_uv_equal(mesh):
    v, f = mesh
    for a, b in zip(juv.unwrap_uv(v, f), tuv.unwrap_uv(v, f)):
        np.testing.assert_array_equal(b, a)


def test_native_ops_equal(mesh, port_lib):
    v, f = mesh
    rng = np.random.default_rng(2)
    protect = (rng.uniform(size=len(f)) < 0.3).astype(np.uint8)
    pairs = [
        (jmo.decimate_mesh(v, f, len(f) // 3),
         tmo.decimate_mesh(v, f, len(f) // 3)),
        (jmo.decimate_mesh(v, f, len(f) // 2, protect=protect,
                           return_src=True),
         tmo.decimate_mesh(v, f, len(f) // 2, protect=protect,
                           return_src=True)),
        (jmo.clean_mesh(v, f, min_f=8, min_d=5),
         tmo.clean_mesh(v, f, min_f=8, min_d=5)),
        (jmo.remesh_mesh(v, f, 0.08, iterations=2),
         tmo.remesh_mesh(v, f, 0.08, iterations=2)),
    ]
    mask = rng.integers(0, 3, len(f))
    pairs.append((jmo.decimate_and_refine_mesh(v, f, mask, 0.1, 0.05, 0.08),
                  tmo.decimate_and_refine_mesh(v, f, mask, 0.1, 0.05, 0.08)))
    for want, got in pairs:
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)


def test_numpy_ops_equal(mesh):
    v, f = mesh
    rng = np.random.default_rng(3)
    m = rng.uniform(size=len(f)) < 0.5
    for a, b in zip(jmo.remove_masked_trigs(v, f, m, dilation=2),
                    tmo.remove_masked_trigs(v, f, m, dilation=2)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jmo.remove_selected_verts(v, f, jmo.select_inside_box(0.3)),
                    tmo.remove_selected_verts(v, f, tmo.select_inside_box(0.3))):
        np.testing.assert_array_equal(b, a)
    box = np.array([-0.5, -0.4, -0.6, 0.5, 0.45, 0.3], np.float32)
    np.testing.assert_array_equal(tmo.select_outside_box(box)(v),
                                  jmo.select_outside_box(box)(v))
    sel = rng.uniform(size=len(f)) < 0.2
    for a, b in zip(jmo.midpoint_subdivide(v, f, sel, return_parents=True),
                    tmo.midpoint_subdivide(v, f, sel, return_parents=True)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n,dilate", [(32, True), (3, False), (1, False)])
def test_bake_mask_growth_matches_scipy(n, dilate):
    """The export grows its chart mask on the device as scipy.ndimage's
    binary_dilation / binary_erosion (cross structure, border False)."""
    import torch
    from scipy.ndimage import binary_dilation, binary_erosion
    from nerf2mesh_tpu_torch.meshing.export import _grow
    rng = np.random.default_rng(n)
    m = np.zeros((120, 96), bool)
    for _ in range(8):
        y, x = rng.integers(0, 120), rng.integers(0, 96)
        m[max(0, y - 9):y + 7, max(0, x - 5):x + 11] = True
    m[:3, :4] = True
    want = (binary_dilation if dilate else binary_erosion)(m, iterations=n)
    np.testing.assert_array_equal(_grow(torch.from_numpy(m), n, dilate).numpy(),
                                  want)
