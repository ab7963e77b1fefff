"""Geometric regularizers: Laplacian smoothness, dihedral flatten, symmetry
chamfer, pull-far, deformation, camera geodesic (counterpart of
selfcorr_tpu/losses/regularizers.py).

The symmetry loss rotates the vertices by R^T and reuses one surface sample
set per batch element (|v - s R| = |v R^T - s|), as the JAX package does."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from selfcorr_tpu_torch.ops.geometry import camera_geodesic
from selfcorr_tpu_torch.ops.knn import chamfer_single_way
from selfcorr_tpu_torch.ops.mesh_ops import sample_surface


def laplacian_loss(pred_v, laplacian):
    """Mean over the batch of sum_i |L pred_v|_i^2. laplacian (V, V)."""
    lx = torch.einsum("vw,bwc->bvc", laplacian, pred_v)
    return (lx ** 2).sum(dim=(1, 2)).mean()


def flatten_loss(pred_v, quads, eps: float = 1e-6):
    """Dihedral-angle flatten loss over edge quadruples (v0s, v1s, v2s,
    v3s): the shared edge's endpoints, then the two opposite vertices."""
    v0, v1, v2, v3 = (pred_v[:, q] for q in quads)

    def perp(a, b, al2, ab):
        return b - a * (ab / (al2 + eps))[..., None]

    a1 = v1 - v0
    b1 = v2 - v0
    a1l2 = (a1 ** 2).sum(-1)
    b1l1 = torch.sqrt((b1 ** 2).sum(-1) + eps)
    ab1 = (a1 * b1).sum(-1)
    cos1 = ab1 / (torch.sqrt(a1l2 + eps) * b1l1 + eps)
    cb1 = perp(a1, b1, a1l2, ab1)
    cb1l1 = b1l1 * torch.sqrt(1 - cos1 ** 2 + eps)

    b2 = v3 - v0
    b2l1 = torch.sqrt((b2 ** 2).sum(-1) + eps)
    ab2 = (a1 * b2).sum(-1)
    cos2 = ab2 / (torch.sqrt(a1l2 + eps) * b2l1 + eps)
    cb2 = perp(a1, b2, a1l2, ab2)
    cb2l1 = b2l1 * torch.sqrt(1 - cos2 ** 2 + eps)

    cos = (cb1 * cb2).sum(-1) / (cb1l1 * cb2l1 + eps)
    return ((cos + 1) ** 2).sum(-1).mean()


def symmetry_loss(pred_v, faces, symm_rots, n_samples: int = 10000,
                  u=None, ub=None, generator=None):
    """One-way chamfer from the symmetry-rotated vertices to the predicted
    surface. pred_v (B, V, 3); symm_rots (k, 3, 3); draws u, ub as in
    sample_surface. Scalar mean over the B * k * V rotated vertices, which
    equals the JAX package's mean over B * k one-way chamfers of V: each
    batch element's k * V rotated vertices search its own samples once,
    rather than k repeats of them."""
    b, v, _ = pred_v.shape
    k = symm_rots.shape[0]
    samples = sample_surface(pred_v, faces, n_samples, u=u, ub=ub,
                             generator=generator)
    v_rot = torch.einsum("bvc,kdc->bkvd", pred_v, symm_rots).reshape(
        b, k * v, 3)
    return chamfer_single_way(v_rot, samples)


def pullfar_loss(translation):
    """relu(1 - z).mean(): keeps objects in front of the camera."""
    return F.relu(1.0 - translation[..., -1]).mean()


def deform_loss(pred_v, mean_v):
    """Smooth-L1 (beta 1) between the deformed and the mean shape."""
    d = torch.abs(pred_v - mean_v)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def camera_loss(r1, r2):
    """Geodesic angle between consecutive frames' rotations."""
    return camera_geodesic(r1, r2)
