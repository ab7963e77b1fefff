"""Per-category canonical shape priors as watertight OBJ meshes (the port's
own copy of scripts/gen_priors.py; its output equals the committed
config/wild6d/priors/*.obj byte for byte).

Parametric meshes in the orientation conventions of the reference's
hand-made priors (measured extents after normalize_prior):
  laptop: open clamshell, base in the xz-plane, screen tilted up (+y,+z)
  bottle: upright along y (tall), rotationally symmetric
  bowl:   opening up in +y, wide in xz, rotationally symmetric
  camera: box widest in x, lens cylinder along +z
  mug:    cylinder along y + handle in the x=0 plane (x-mirror symmetric)

All meshes are centered and normalized again at load
(ops/mesh_ops.normalize_prior), so only proportions and orientation matter.
Each mesh is a union of watertight components (closed 2-manifolds), CCW
outward winding.

  python -m selfcorr_tpu_torch.tools.gen_priors [out_dir]
      (default out_dir: config/wild6d/priors under the repository's root)
"""
from __future__ import annotations

import os
import sys

import numpy as np

from selfcorr_tpu_torch.ops.mesh_ops import save_obj

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "config", "wild6d", "priors")


def lathe(profile, n_seg: int = 32):
    """Surface of revolution around y: profile = [(r, y), ...] bottom->top.

    End rings with r=0 become pole vertices; otherwise the ends are capped
    with a fan around a center vertex. Returns a watertight (verts, faces).
    """
    profile = [(float(r), float(y)) for r, y in profile]
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)
    verts, rings = [], []
    for r, y in profile:
        if r <= 1e-9:
            verts.append([0.0, y, 0.0])
            rings.append(("pole", len(verts) - 1))
        else:
            base = len(verts)
            verts.extend([[r * c, y, r * s] for c, s in zip(ca, sa)])
            rings.append(("ring", base))
    faces = []

    def quad(a, b, c, d):  # two CCW triangles for an outward quad
        faces.append([a, b, c])
        faces.append([a, c, d])

    for (k0, i0), (k1, i1) in zip(rings[:-1], rings[1:]):
        for s in range(n_seg):
            t = (s + 1) % n_seg
            if k0 == "ring" and k1 == "ring":
                quad(i0 + s, i0 + t, i1 + t, i1 + s)
            elif k0 == "pole" and k1 == "ring":
                faces.append([i0, i1 + t, i1 + s])
            elif k0 == "ring" and k1 == "pole":
                faces.append([i1, i0 + s, i0 + t])
    # cap open ends (first/last ring not a pole)
    if rings[0][0] == "ring":
        c = len(verts)
        verts.append([0.0, profile[0][1], 0.0])
        i0 = rings[0][1]
        for s in range(n_seg):
            faces.append([c, i0 + s, i0 + (s + 1) % n_seg])
    if rings[-1][0] == "ring":
        c = len(verts)
        verts.append([0.0, profile[-1][1], 0.0])
        i0 = rings[-1][1]
        for s in range(n_seg):
            faces.append([c, i0 + (s + 1) % n_seg, i0 + s])
    # rings run clockwise seen from +y (x=cos, z=sin in a right-handed,
    # y-up frame), so the consistent winding above is inward: flip it.
    faces = np.asarray(faces, np.int64)[:, [0, 2, 1]]
    return np.asarray(verts), faces


def grid_face(nu, nv):
    """Triangulated (nu+1)x(nv+1) index grid -> faces into row-major ids."""
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = a + 1
            c = a + (nv + 1) + 1
            d = a + (nv + 1)
            faces.append([a, c, b])
            faces.append([a, d, c])
    return np.asarray(faces, np.int64)


def box(size, nsub=3):
    """Watertight subdivided box centered at origin, outward CCW winding.

    Built face-by-face with welded shared edges (vertex dedup by position).
    """
    sx, sy, sz = [s / 2 for s in size]
    verts, faces, index = [], [], {}

    def vid(p):
        key = tuple(np.round(p, 9))
        if key not in index:
            index[key] = len(verts)
            verts.append(list(p))
        return index[key]

    def add_face(origin, du, dv):
        n = nsub
        grid = np.empty((n + 1, n + 1), np.int64)
        for i in range(n + 1):
            for j in range(n + 1):
                p = (np.asarray(origin) + np.asarray(du) * (i / n)
                     + np.asarray(dv) * (j / n))
                grid[i, j] = vid(p)
        for f in grid_face(n, n):
            faces.append([grid.flat[f[0]], grid.flat[f[1]], grid.flat[f[2]]])

    # 6 faces with outward CCW orientation (du x dv = outward normal)
    add_face((-sx, -sy, +sz), (2 * sx, 0, 0), (0, 2 * sy, 0))   # +z
    add_face((+sx, -sy, -sz), (-2 * sx, 0, 0), (0, 2 * sy, 0))  # -z
    add_face((+sx, -sy, +sz), (0, 0, -2 * sz), (0, 2 * sy, 0))  # +x
    add_face((-sx, -sy, -sz), (0, 0, 2 * sz), (0, 2 * sy, 0))   # -x
    add_face((-sx, +sy, +sz), (2 * sx, 0, 0), (0, 0, -2 * sz))  # +y
    add_face((-sx, -sy, -sz), (2 * sx, 0, 0), (0, 0, 2 * sz))   # -y
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def torus(R, r, n_major=24, n_minor=10):
    """Watertight torus whose major circle lies in the xy-plane (axis z)."""
    verts, faces = [], []
    for i in range(n_major):
        a = 2 * np.pi * i / n_major
        ca, sa = np.cos(a), np.sin(a)
        for j in range(n_minor):
            b = 2 * np.pi * j / n_minor
            cb, sb = np.cos(b), np.sin(b)
            # major circle in xy-plane; tube offset radial + z
            verts.append([(R + r * cb) * ca, (R + r * cb) * sa, r * sb])
    for i in range(n_major):
        i2 = (i + 1) % n_major
        for j in range(n_minor):
            j2 = (j + 1) % n_minor
            a = i * n_minor + j
            b = i2 * n_minor + j
            c = i2 * n_minor + j2
            d = i * n_minor + j2
            faces.append([a, b, c])
            faces.append([a, c, d])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def transform(vf, R=None, t=None):
    v, f = vf
    if R is not None:
        v = v @ np.asarray(R).T
    if t is not None:
        v = v + np.asarray(t)
    return v, f


def merge(*parts):
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(np.asarray(f) + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces)


def rot_x(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _densify(prof, n=3):
    """Insert n-1 linear interpolation points between profile knots."""
    out = []
    for (r0, y0), (r1, y1) in zip(prof[:-1], prof[1:]):
        for k in range(n):
            t = k / n
            out.append((r0 + t * (r1 - r0), y0 + t * (y1 - y0)))
    out.append(prof[-1])
    return out


def make_laptop():
    # base slab flat in xz; screen slab hinged at z=-0.5, tilted back ~65deg
    base = box((1.7, 0.12, 1.5), nsub=7)
    base = transform(base, t=(0, -0.3, 0.25))
    screen = box((1.7, 0.1, 1.45), nsub=7)
    # stand the screen up: slab thickness along z after rotation
    screen = transform(screen, R=rot_x(-115), t=(0, 0.25, -0.72))
    return merge(base, screen)


def make_bottle():
    prof = [(0.0, -1.0), (0.30, -0.98), (0.37, -0.85), (0.38, -0.2),
            (0.36, 0.15), (0.25, 0.45), (0.15, 0.65), (0.13, 0.85),
            (0.14, 0.93), (0.0, 0.95)]
    return lathe(_densify(prof, 2), n_seg=36)


def make_bowl():
    # solid bowl: outer wall up to the rim, then the profile dips back
    # inward/down (concave interior), closing at the inner bottom center
    prof = [(0.0, -0.5), (0.5, -0.48), (0.85, -0.25), (1.0, 0.42),
            (1.0, 0.5), (0.92, 0.5), (0.8, 0.1), (0.45, -0.28), (0.0, -0.32)]
    return lathe(_densify(prof, 2), n_seg=40)


def make_camera():
    body = box((2.0, 1.1, 0.85), nsub=7)
    lens = lathe(_densify([(0.0, -0.05), (0.42, 0.0), (0.42, 0.55),
                           (0.0, 0.6)], 2), n_seg=28)
    # lens axis along +z: rotate lathe's y-axis onto z, stick out the front
    lens = transform(lens, R=rot_x(90), t=(0.25, 0.05, 0.42))
    return merge(body, lens)


def make_mug():
    body = lathe(_densify([(0.0, -0.9), (0.62, -0.88), (0.66, 0.8),
                           (0.68, 0.9), (0.6, 0.9), (0.55, 0.75),
                           (0.5, -0.6), (0.0, -0.65)], 2), n_seg=32)
    handle = torus(0.42, 0.1, n_major=26, n_minor=10)
    # handle in the z-y plane (x=0): torus tube circles in xy -> rotate so
    # its plane is zy, then offset in +z to meet the wall
    Ry = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], float)
    handle = transform(handle, R=Ry, t=(0.0, 0.05, 0.78))
    return merge(body, handle)


def check_mesh(verts, faces):
    """Raise ValueError unless the mesh is watertight (every edge in exactly
    two faces) and wound outward (positive total signed volume, by the
    divergence theorem)."""
    from collections import Counter
    edges = Counter()
    for a, b, c in faces:
        for u, v in ((a, b), (b, c), (c, a)):
            edges[(min(u, v), max(u, v))] += 1
    bad = [e for e, n in edges.items() if n != 2]
    if bad:
        raise ValueError(f"non-manifold edges: {bad[:5]} ({len(bad)} total)")
    fv = verts[faces]
    vol = np.einsum("fi,fi->f", fv[:, 0],
                    np.cross(fv[:, 1], fv[:, 2])).sum() / 6.0
    if not vol > 0:
        raise ValueError(f"net inward winding (signed volume {vol:.4f})")


GENERATORS = dict(laptop=make_laptop, bottle=make_bottle, bowl=make_bowl,
                  camera=make_camera, mug=make_mug)


def main(out_dir: str = DEFAULT_OUT) -> None:
    """Write <out_dir>/<category>.obj for every category, each checked
    watertight and outward-wound first."""
    os.makedirs(out_dir, exist_ok=True)
    for cat, fn in GENERATORS.items():
        verts, faces = fn()
        check_mesh(verts, faces)
        path = os.path.join(out_dir, f"{cat}.obj")
        save_obj(path, verts, faces)
        print(f"{path}: {len(verts)} verts, {len(faces)} faces")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT)
