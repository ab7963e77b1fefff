"""Oriented 3D boxes and exact IoU on the host (the port's own copy of
selfcorr_tpu/eval/box3d.py; numpy + scipy only).

A box is (center + 8 corners). IoU is exact: the intersection polytope is
built by clipping each face polygon of one box against the other's
half-spaces (Sutherland-Hodgman in 3D) plus the contained vertices, and its
volume comes from scipy's ConvexHull.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull, QhullError

# unit box corner pattern, matches the reference bbox-9 construction
# (tester.py:406-418): vertex 0 = center, then (x,y,z) in {-,+}^3 ordered
# z-fastest
UNIT_CORNERS = np.array(
    [[0, 0, 0],
     [-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
     [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1]], np.float64) * 0.5


class Box3D:
    """Oriented box: vertices (9, 3) — row 0 is the center."""

    def __init__(self, vertices: np.ndarray):
        v = np.asarray(vertices, np.float64)
        assert v.shape == (9, 3)
        self.vertices = v

    @classmethod
    def from_transformation(cls, rotation: np.ndarray, translation: np.ndarray,
                            size: np.ndarray) -> "Box3D":
        """objectron convention (box.py:55-68): x' = R x + t, column-acting R
        on unit-box corners scaled by size."""
        pts = UNIT_CORNERS * np.asarray(size, np.float64)
        return cls(pts @ np.asarray(rotation, np.float64).T
                   + np.asarray(translation, np.float64))

    @property
    def center(self):
        return self.vertices[0]

    @property
    def rotation(self):
        """Column-acting rotation reconstructed from the corner frame."""
        x = self.vertices[5] - self.vertices[1]
        y = self.vertices[3] - self.vertices[1]
        z = self.vertices[2] - self.vertices[1]
        R = np.stack([x / np.linalg.norm(x), y / np.linalg.norm(y),
                      z / np.linalg.norm(z)], axis=1)
        return R

    @property
    def size(self):
        return np.array([
            np.linalg.norm(self.vertices[5] - self.vertices[1]),
            np.linalg.norm(self.vertices[3] - self.vertices[1]),
            np.linalg.norm(self.vertices[2] - self.vertices[1])])

    def volume(self) -> float:
        return float(np.prod(self.size))

    def halfspaces(self):
        """6 (normal, offset) with inside = n.x <= d."""
        R = self.rotation
        c = self.center
        s = self.size / 2.0
        planes = []
        for axis in range(3):
            n = R[:, axis]
            planes.append((n, float(n @ c + s[axis])))
            planes.append((-n, float(-(n @ c) + s[axis])))
        return planes

    def faces(self):
        """6 face polygons (4 vertices each, consistent winding not needed)."""
        idx = [[1, 2, 4, 3], [5, 6, 8, 7], [1, 2, 6, 5],
               [3, 4, 8, 7], [1, 3, 7, 5], [2, 4, 8, 6]]
        return [self.vertices[i] for i in idx]

    def contains(self, pts: np.ndarray, eps: float = 1e-9) -> np.ndarray:
        rel = (pts - self.center) @ self.rotation
        return np.all(np.abs(rel) <= self.size / 2.0 + eps, axis=-1)


def _clip_polygon(poly: np.ndarray, normal, offset, eps=1e-12) -> np.ndarray:
    """Clip 3D polygon by halfspace n.x <= d (Sutherland–Hodgman)."""
    if len(poly) == 0:
        return poly
    d = poly @ normal - offset
    out = []
    n = len(poly)
    for i in range(n):
        j = (i + 1) % n
        di, dj = d[i], d[j]
        if di <= eps:
            out.append(poly[i])
        if (di < -eps and dj > eps) or (di > eps and dj < -eps):
            t = di / (di - dj)
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, 3))


def intersection_points(a: Box3D, b: Box3D) -> np.ndarray:
    pts = []
    for poly in a.faces():
        p = np.asarray(poly, np.float64)
        for n, d in b.halfspaces():
            p = _clip_polygon(p, n, d)
            if len(p) == 0:
                break
        if len(p):
            pts.append(p)
    inside = a.vertices[1:][b.contains(a.vertices[1:])]
    if len(inside):
        pts.append(inside)
    inside_b = b.vertices[1:][a.contains(b.vertices[1:])]
    if len(inside_b):
        pts.append(inside_b)
    return np.concatenate(pts) if pts else np.zeros((0, 3))


def box_iou(a: Box3D, b: Box3D) -> float:
    pts = intersection_points(a, b)
    if len(pts) < 4:
        return 0.0
    try:
        inter = ConvexHull(pts, qhull_options="QJ").volume
    except QhullError:
        return 0.0
    union = a.volume() + b.volume() - inter
    if union <= 0:
        return 0.0
    return float(np.clip(inter / union, 0.0, 1.0))
