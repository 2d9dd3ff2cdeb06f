"""UV unwrapping (replaces xatlas, reference renderer.py:313-321).

Axis-projection charting: faces are binned by dominant normal axis (6 bins),
split into connected components per bin (charts), projected onto their two
tangent axes, and shelf-packed into the unit square.  Chart vertices are
duplicated per chart, so the output matches xatlas's (vmapping, ft, vt)
contract: vt [Nuv, 2] in [0, 1], ft [F, 3] indexes vt, vmapping [Nuv] maps
uv-vertices back to mesh vertices.

Not as texel-efficient as xatlas's LSCM charts, but dependency-free,
deterministic and fast; the exporter's KNN inpainting covers chart borders.


A copy of ``nerf2mesh_tpu/meshing/uvatlas.py`` (the port imports nothing of the JAX
package); tests/test_torch_meshing.py holds the two equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def unwrap_uv(verts: np.ndarray, tris: np.ndarray,
              padding: float = 4.0 / 1024.0,
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (vmapping [Nuv], ft [F, 3], vt [Nuv, 2])."""
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    F = len(tris)
    if F == 0:
        return (np.zeros(0, np.int64), np.zeros((0, 3), np.int64),
                np.zeros((0, 2), np.float32))

    # 1. dominant axis bin per face (0..5: +x,-x,+y,-y,+z,-z)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    ax = np.argmax(np.abs(n), axis=-1)
    sign = np.take_along_axis(n, ax[:, None], 1)[:, 0] >= 0
    bin_id = ax * 2 + (~sign).astype(np.int64)

    # 2. connected components among faces sharing an edge AND a bin
    parent = np.arange(F)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    fid = np.tile(np.arange(F), 3)
    es = np.sort(edges, axis=1)
    key = es[:, 0] * (len(verts) + 1) + es[:, 1]
    order = np.argsort(key, kind="stable")
    ks, fs = key[order], fid[order]
    same = ks[1:] == ks[:-1]
    for i in np.nonzero(same)[0]:
        fa, fb = fs[i], fs[i + 1]
        if bin_id[fa] == bin_id[fb]:
            ra, rb = find(fa), find(fb)
            if ra != rb:
                parent[rb] = ra
    roots = np.array([find(f) for f in range(F)])
    chart_ids, chart_inv = np.unique(roots, return_inverse=True)
    n_charts = len(chart_ids)

    # 3. project each chart onto its tangent plane
    TANGENTS = {
        0: (1, 2), 1: (2, 1),   # +-x -> (y,z)/(z,y) to keep orientation
        2: (2, 0), 3: (0, 2),
        4: (0, 1), 5: (1, 0),
    }
    ft = np.zeros((F, 3), np.int64)
    chart_uv = []        # per chart: (uv array, vmap array)
    chart_rect = np.zeros((n_charts, 2))

    uv_all = []
    vmap_all = []
    uv_offset = 0
    chart_slices = []
    for c in range(n_charts):
        faces = np.nonzero(chart_inv == c)[0]
        b = bin_id[roots[faces[0]]] if False else bin_id[faces[0]]
        a0, a1 = TANGENTS[int(b)]
        vids = np.unique(tris[faces].reshape(-1))
        local = {v: i for i, v in enumerate(vids)}
        uv = verts[vids][:, [a0, a1]]
        uv = uv - uv.min(0)
        chart_rect[c] = uv.max(0) + 1e-9
        for f in faces:
            for k in range(3):
                ft[f, k] = uv_offset + local[tris[f, k]]
        uv_all.append(uv)
        vmap_all.append(vids)
        chart_slices.append((uv_offset, uv_offset + len(vids)))
        uv_offset += len(vids)

    vt = np.concatenate(uv_all).astype(np.float64)
    vmapping = np.concatenate(vmap_all).astype(np.int64)

    # 4. shelf-pack chart rects into unit square
    # scale so total chart area ~ fill_factor of the square
    areas = chart_rect[:, 0] * chart_rect[:, 1]
    scale = np.sqrt(0.55 / max(areas.sum(), 1e-12))
    rects = chart_rect * scale + padding

    order = np.argsort(-rects[:, 1])   # tallest first
    x = y = shelf_h = 0.0
    pos = np.zeros((n_charts, 2))
    for c in order:
        w, h = rects[c]
        w = min(w, 1.0)
        if x + w > 1.0:
            x = 0.0
            y += shelf_h
            shelf_h = 0.0
        pos[c] = (x, y)
        x += w
        shelf_h = max(shelf_h, h)
    total_h = y + shelf_h
    norm = max(total_h, 1.0)

    for c in range(n_charts):
        s, e = chart_slices[c]
        vt[s:e] = (vt[s:e] * scale + pos[c] + padding / 2) / norm
    vt = np.clip(vt, 0.0, 1.0)

    return vmapping, ft.astype(np.int64), vt.astype(np.float32)
