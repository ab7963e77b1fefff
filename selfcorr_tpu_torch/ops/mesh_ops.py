"""Host-side mesh builders (counterpart of selfcorr_tpu/ops/mesh_ops.py):
OBJ loading, prior normalization, icosphere, graph Laplacian and the
flatten-loss quadruples that build_mesh_constants needs. Pure numpy."""
from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 3):
    """Subdivided icosahedron (3 -> 642 verts / 1280 faces), outward CCW.
    Returns (verts float64 (V, 3), faces int64 (F, 3))."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid: dict = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                verts_list.append(m / np.linalg.norm(m))
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces.tolist():
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    return verts, faces


def load_obj(path: str):
    """Minimal OBJ parser: vertices + fan-triangulated faces."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def normalize_prior(verts: np.ndarray, init_scale=(1.0, 1.0, 1.0)):
    """Center at the mean, scale max |coord| to 1, then per-axis
    init_scale."""
    v = verts - verts.mean(0)
    v = v / np.abs(v).max()
    return v * np.asarray(init_scale, v.dtype)


def laplacian_matrix(num_verts: int, faces: np.ndarray) -> np.ndarray:
    """Row-normalized dense graph Laplacian (V, V) float32: L[i,i] = 1,
    L[i,j] = -1/deg(i) on mesh edges; isolated rows stay zero."""
    L = np.zeros((num_verts, num_verts), np.float32)
    f = np.asarray(faces)
    for a, b in [(0, 1), (1, 0), (1, 2), (2, 1), (2, 0), (0, 2)]:
        L[f[:, a], f[:, b]] = -1.0
    deg = -L.sum(1)
    np.fill_diagonal(L, deg)
    nz = deg != 0
    L[nz] /= deg[nz, None]
    return L


def flatten_quads(faces: np.ndarray):
    """(v0, v1, v2, v3) int32 arrays for every edge shared by exactly two
    faces: the edge's endpoints, then the two opposite vertices."""
    f = np.asarray(faces)
    edge_faces: dict = {}
    for fi, (a, b, c) in enumerate(f.tolist()):
        for u, v in [(a, b), (b, c), (a, c)]:
            edge_faces.setdefault((min(u, v), max(u, v)), []).append(fi)
    quads = []
    for (u, v), flist in sorted(edge_faces.items()):
        if len(flist) != 2:
            continue
        opp = [(set(f[fi].tolist()) - {u, v}).pop() for fi in flist]
        quads.append((u, v, opp[0], opp[1]))
    q = np.asarray(quads, np.int32).reshape(-1, 4)
    return tuple(q[:, k].copy() for k in range(4))
