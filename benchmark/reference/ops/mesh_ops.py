"""Mesh builders and mesh math (counterpart of
selfcorr_tpu/ops/mesh_ops.py): host-side numpy builders (OBJ loading and saving, prior
normalization, icosphere, graph Laplacian, flatten-loss quadruples) and the
device-side face gathers, areas and area-weighted surface sampling."""
from __future__ import annotations

import numpy as np
import torch


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


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Vertices (8 decimals) and 1-based triangles as OBJ text, the JAX
    package's format (load_obj reads it back)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


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


# ---------------------------------------------------------------------------
# Device-side mesh math
# ---------------------------------------------------------------------------

def face_vertices(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3), (F, 3) -> (B, F, 3, 3) per-face corner coordinates."""
    return verts[:, faces]


def face_areas(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3), (F, 3) -> (B, F) triangle areas."""
    fv = face_vertices(verts, faces)
    e1 = fv[..., 1, :] - fv[..., 0, :]
    e2 = fv[..., 2, :] - fv[..., 0, :]
    return 0.5 * torch.linalg.vector_norm(torch.linalg.cross(e1, e2, dim=-1),
                                          dim=-1)


def surface_draws(generator: torch.Generator, b: int, num_samples: int):
    """The uniform draws of sample_surface, on the CPU: u (B, S, 1) picks
    the face, ub (B, S, 2) the point in it."""
    u = torch.rand((b, num_samples, 1), generator=generator)
    ub = torch.rand((b, num_samples, 2), generator=generator)
    return u, ub


def sample_surface(verts: torch.Tensor, faces: torch.Tensor,
                   num_samples: int, u: torch.Tensor | None = None,
                   ub: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Area-weighted uniform surface sampling -> (B, num_samples, 3),
    differentiable in the vertices (the face pick is not).

    The JAX package picks face f for draw u where cum_{f-1} <= u * total <
    cum_f (an inverse-CDF interval mask, selfcorr_tpu/ops/mesh_ops.py:200);
    here that face is found by searchsorted over the same cumulative areas,
    so the same u picks the same face and a zero-area face, whose interval is
    empty, is never picked. A draw that rounds onto the total matches no
    interval and, as in the JAX package, samples the origin. The point in
    the face folds ub onto the triangle: w = (1 - sqrt(ub0),
    sqrt(ub0) (1 - ub1), sqrt(ub0) ub1). u and ub are the draws (see
    surface_draws); absent, they come from `generator`."""
    b = verts.shape[0]
    if u is None or ub is None:
        if generator is None:
            raise ValueError("sample_surface needs draws or a generator")
        u, ub = surface_draws(generator, b, num_samples)
    u = u.to(verts.device)
    ub = ub.to(verts.device)
    cum = torch.cumsum(face_areas(verts, faces).detach(), dim=-1)   # (B, F)
    target = (u * cum[:, -1:, None])[..., 0]                        # (B, S)
    idx = torch.searchsorted(cum.contiguous(), target.contiguous(),
                             right=True)
    hit = (idx < cum.shape[1])[..., None]
    fv9 = face_vertices(verts, faces).reshape(b, -1, 9)
    tri = torch.gather(fv9, 1, idx.clamp(max=cum.shape[1] - 1)[..., None]
                       .expand(-1, -1, 9)) * hit
    tri = tri.reshape(b, num_samples, 3, 3)
    su = torch.sqrt(ub[..., 0])
    w0 = 1.0 - su
    w1 = su * (1.0 - ub[..., 1])
    w2 = su * ub[..., 1]
    return (w0[..., None] * tri[:, :, 0] + w1[..., None] * tri[:, :, 1]
            + w2[..., None] * tri[:, :, 2])
