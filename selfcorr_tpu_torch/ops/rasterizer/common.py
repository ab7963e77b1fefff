"""Shared rasterizer math: constants, pixel grid, per-face constant packing
(counterpart of selfcorr_tpu/ops/rasterizer/common.py and of the slot
layout of pallas_raster.py:54-73,114-188).

Both the plain PyTorch fused forward (reference.py) and the CUDA kernel
(csrc/raster_fwd.cu) read the (B, F, K=64) packed constants built here, so
they evaluate the same per-face affine forms. The slot layout is the JAX
package's, so the backward kernel of the training slice can reuse it. Faces
keep their original order (no sort, no padding): the kernel loops to exactly
F, and the hard winner's "earliest face wins z-ties" refers to that order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

# look_at eye offset of the reference renderer (viewing angle 30 deg):
# z_rast = z_cam + EYE_OFFSET
EYE_OFFSET = 1.0 / math.tan(math.radians(30.0)) + 1.0

NEAR = 1.0
FAR = 100.0
BG_EPS = 1e-3          # background pseudo-depth in the softmax
DIST_EPS_RAW = 1e-4
# outside faces whose squared distance reaches sigma * DIST_CUT contribute
# nothing (their coverage would be below DIST_EPS_RAW)
DIST_CUT = math.log(1.0 / DIST_EPS_RAW - 1.0)

# packed slot layout (pallas_raster.py:54-73)
K = 64
S_WA = 0      # 9: barycentric affine coeffs (3 bary x [ax, ay, ac])
S_SEG = 9     # 9: per-edge segment-parameter affine coeffs
S_E2 = 18     # 3: squared edge lengths
S_PC = 21     # 9: per-edge |p - v0|^2 affine coeffs
S_IZ = 30     # 3: 1/z per corner
S_Z = 33      # 3: z per corner
S_FRONT = 36  # 1: front-side flag
S_BBOX = 37   # 4: xmin, xmax, ymin, ymax
S_STEX = 41   # 9: soft texture (3 corners x rgb)
S_HTEX = 50   # 9: hard texture
N_SLOTS = 59


def pixel_grid(image_size: int, device=None, dtype=torch.float32):
    """Pixel-centre NDC coords flattened row-major (top row first):
    row r has y = (S-1-2r) * (1/S), column c has x = (2c+1-S) * (1/S).
    Returns (S*S,) xp and (S*S,) yp.

    The rasterizer's divisions by a constant are multiplications by its
    float32 reciprocal, here, in reference.py and in the CUDA kernel alike,
    so all three round identically on every device."""
    s = image_size
    r = torch.arange(s, dtype=dtype, device=device)
    xs = (2.0 * r + 1.0 - s) * (1.0 / s)
    ys = (s - 1.0 - 2.0 * r) * (1.0 / s)
    return xs.repeat(s), ys.repeat_interleave(s)


class FaceConstants(NamedTuple):
    """Per-face affine data, all (B, F, ...). At pixel (x, y):
      bary w_k      = w_a[..., k, 0] x + w_a[..., k, 1] y + w_a[..., k, 2]
      seg param s_e = seg[..., e, 0] x + seg[..., e, 1] y + seg[..., e, 2]
      |p - v0_e|^2  = (x^2 + y^2) + pc[..., e, 0] x + pc[..., e, 1] y
                      + pc[..., e, 2]
      seg dist_e    = |p - v0|^2 - t (2 s - t) e2,  t = clamp(s, 0, 1)
    """
    w_a: torch.Tensor    # (B, F, 3, 3)
    seg: torch.Tensor    # (B, F, 3, 3)
    e2: torch.Tensor     # (B, F, 3)
    pc: torch.Tensor     # (B, F, 3, 3)
    inv_z: torch.Tensor  # (B, F, 3)
    z: torch.Tensor      # (B, F, 3)
    front: torch.Tensor  # (B, F)
    bbox: torch.Tensor   # (B, F, 4)


def pack_face_constants(face_verts: torch.Tensor) -> FaceConstants:
    """face_verts (B, F, 3, 3) in rasterizer space (x, y NDC; z depth)."""
    x = face_verts[..., 0]
    y = face_verts[..., 1]
    z = face_verts[..., 2]
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)

    # barycentric inverse, det clamped away from zero
    det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    det = torch.where(det >= 0, torch.clamp(det, min=1e-10),
                      torch.clamp(det, max=-1e-10))
    inv = torch.stack([
        torch.stack([y1 - y2, x2 - x1, x1 * y2 - x2 * y1], -1),
        torch.stack([y2 - y0, x0 - x2, x2 * y0 - x0 * y2], -1),
        torch.stack([y0 - y1, x1 - x0, x0 * y1 - x1 * y0], -1),
    ], -2) / det[..., None, None]

    # edge k runs v_k -> v_{k+1}
    xn = torch.stack([x1, x2, x0], -1)
    yn = torch.stack([y1, y2, y0], -1)
    xv = torch.stack([x0, x1, x2], -1)
    yv = torch.stack([y0, y1, y2], -1)
    ex = xn - xv
    ey = yn - yv
    e2 = torch.clamp(ex * ex + ey * ey, min=1e-12)
    seg = torch.stack([ex / e2, ey / e2, -(xv * ex + yv * ey) / e2], -1)
    pc = torch.stack([-2.0 * xv, -2.0 * yv, xv * xv + yv * yv], -1)
    front = ((y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0)).to(
        face_verts.dtype)
    bbox = torch.stack([x.amin(-1), x.amax(-1), y.amin(-1), y.amax(-1)], -1)
    return FaceConstants(w_a=inv, seg=seg, e2=e2, pc=pc,
                         inv_z=1.0 / z, z=z, front=front, bbox=bbox)


def pack_constants(face_verts: torch.Tensor, soft_tex: torch.Tensor,
                   hard_tex: torch.Tensor) -> torch.Tensor:
    """(B, F, 3, 3) verts + per-corner textures -> (B, F, K) float32 in the
    slot layout above; slots N_SLOTS..K-1 are zero. Differentiable in the
    vertices and the soft texture; the hard texture is detached, as in
    pallas_raster.py:165 (the match render takes no gradient)."""
    b, f = face_verts.shape[:2]
    c = pack_face_constants(face_verts)
    cols = [c.w_a.reshape(b, f, 9), c.seg.reshape(b, f, 9), c.e2,
            c.pc.reshape(b, f, 9), c.inv_z, c.z, c.front[..., None], c.bbox,
            soft_tex.reshape(b, f, 9), hard_tex.detach().reshape(b, f, 9)]
    packed = torch.cat(cols, dim=-1).to(torch.float32)
    return torch.nn.functional.pad(packed, (0, K - N_SLOTS)).contiguous()
