"""Camera / rotation geometry (counterpart of selfcorr_tpu/ops/geometry.py).

Conventions kept from the JAX package:
  * rotations act on ROW vectors: ``v_cam = v_obj @ R + t``;
  * NDC projection ``x' = pp_x + x * f_x / z``, y flipped for the
    rasterizer;
  * quaternions are WXYZ.
"""
from __future__ import annotations

import numpy as np
import torch


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """L2-normalize along `dim` (x / max(|x|, eps))."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def rot6d_to_matrix(x6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt 6D rotation -> (..., 3, 3) with columns (x, y, z):
    x = normalize(a); z = normalize(x cross b); y = normalize(z cross x)."""
    a = x6[..., :3]
    b = x6[..., 3:6]
    x = normalize(a)
    z = normalize(torch.linalg.cross(x, b, dim=-1))
    y = normalize(torch.linalg.cross(z, x, dim=-1))
    return torch.stack((x, y, z), dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """WXYZ quaternion -> rotation matrix (..., 3, 3) acting on column
    vectors."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, -2)


def matrix_to_quat(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> WXYZ quaternion with w >= 0
    (Shepperd: of the four candidates, the one whose diagonal term is
    largest)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    diag = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                        1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    cand = torch.stack([
        torch.stack([diag[..., 0], m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, diag[..., 1], m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, diag[..., 2], m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, diag[..., 3]], -1),
    ], -2)
    idx = torch.argmax(diag, -1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = normalize(q, eps=eps)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rigid_transform(verts: torch.Tensor, R: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """Row-vector rigid transform: (..., N, 3) @ (..., 3, 3) + (..., 1, 3)."""
    return torch.matmul(verts, R) + t


def project_ndc(verts_cam: torch.Tensor, pp: torch.Tensor, foc: torch.Tensor,
                flip_y: bool = True) -> torch.Tensor:
    """Pinhole projection into NDC keeping camera z in channel 2.

    verts_cam (B, N, 3); pp, foc (B, 2) NDC. x' = pp_x + x fx / z,
    y' = -(pp_y + y fy / z) when flip_y, z' = z."""
    z = verts_cam[..., 2]
    x = pp[..., None, 0] + verts_cam[..., 0] * foc[..., None, 0] / z
    y = pp[..., None, 1] + verts_cam[..., 1] * foc[..., None, 1] / z
    if flip_y:
        y = -y
    return torch.stack([x, y, z], dim=-1)


# ---------------------------------------------------------------------------
# Host-side numpy constants
# ---------------------------------------------------------------------------

def symmetry_rotations(symmetry_idx: int, division: int = 17) -> np.ndarray:
    """Symmetry-loss rotation set: 0 -> `division`-fold about +y,
    1 -> identity + x-mirror, otherwise identity only."""
    if symmetry_idx == 0:
        thetas = 2.0 * np.pi * np.arange(division) / division
        c, s = np.cos(thetas), np.sin(thetas)
        rots = np.zeros((division, 3, 3), np.float32)
        rots[:, 0, 0] = c
        rots[:, 0, 2] = s
        rots[:, 1, 1] = 1
        rots[:, 2, 0] = -s
        rots[:, 2, 2] = c
        return rots
    if symmetry_idx == 1:
        return np.stack([np.eye(3, dtype=np.float32),
                         np.diag([-1.0, 1.0, 1.0]).astype(np.float32)])
    return np.eye(3, dtype=np.float32)[None]


def base_rotation(flat9) -> np.ndarray:
    """Canonical-frame alignment matrix from the flat 9-list flag."""
    return np.array([float(x) for x in flat9], np.float32).reshape(3, 3)


def camera_geodesic(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotation matrices (..., 3, 3)."""
    m = torch.matmul(m1, m2.transpose(-1, -2))
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def depth_to_point_cloud(depth: torch.Tensor, pp: torch.Tensor,
                         foc: torch.Tensor) -> torch.Tensor:
    """Back-project a (B, H, W) depth map with NDC intrinsics ->
    (B, H*W, 3); pixel centres on the NDC grid, X = (u - pp_x) Z / f_x."""
    b, h, w = depth.shape
    dev, dt = depth.device, depth.dtype
    u = (torch.arange(w, dtype=dt, device=dev) + 0.5) * 2.0 / w - 1.0
    v = (torch.arange(h, dtype=dt, device=dev) + 0.5) * 2.0 / h - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    z = depth
    x = (uu[None] - pp[:, 0, None, None]) * z / foc[:, 0, None, None]
    y = (vv[None] - pp[:, 1, None, None]) * z / foc[:, 1, None, None]
    return torch.stack([x, y, z], dim=-1).reshape(b, -1, 3)
