"""Shared rasterizer math: constants, pixel grid, tile geometry, per-face
constant packing (counterpart of selfcorr_tpu/ops/rasterizer/common.py and
of the slot layout, face sort and padding of pallas_raster.py:54-188).

Every route reads the (B, F_pad, K) packed constants built here, so all of
them evaluate the same per-face affine forms: the plain PyTorch versions
(reference.py), the compact kernels (csrc/raster_fwd.cu, raster_bwd.cu) and
the dense-chunk kernels (csrc/raster_fwd_chunk.cu, raster_bwd_chunk.cu).
pack_constants sorts the faces by (y-band, x) as the JAX package does, so
the chunks of FF consecutive faces are tight in both axes and "the earliest
face wins z-ties" in the match plane refers to the JAX kernel's face order;
it pads F to a multiple of FF with inert faces, and appends the surface
texel grids when it is given them.
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
K = 64        # lanes per face without surface texels; K grows by 64s
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
S_SURF = N_SLOTS  # R^2 x rgb surface texels, when packed

FF = 16            # faces per chunk of the dense-chunk schedule
TR, TC = 8, 128    # the classic tile: 8 rows x min(128, S) columns
_BIG = 1e9         # the padding faces' |p - v0|^2 offset and bbox

# y-band count of the face sort (pallas_raster.py:102-103): 64 bands for
# the classic tiles, 16 for the 16 x 64 lane-split tiles
N_BANDS = 64
N_BANDS_LANE_SPLIT = 16


def lane_split_for(image_size: int) -> bool:
    """Whether the image tiles into 16 x 64-pixel tiles (the JAX package's
    lane-split geometry, pallas_raster.py:221-226, on by default there);
    other sizes keep the classic 8 x min(128, S) tiles."""
    return image_size % (2 * TR) == 0 and image_size % (TC // 2) == 0


def bands_for(image_size: int) -> int:
    return N_BANDS_LANE_SPLIT if lane_split_for(image_size) else N_BANDS


def k_for(tex_res: int) -> int:
    """Packed slots per face for R = tex_res surface texels per side (0:
    none): the used slots rounded up to a multiple of 64."""
    n_slots = N_SLOTS + 3 * tex_res * tex_res
    return max(K, -(-n_slots // 64) * 64)


def pixel_grid(image_size: int, device=None, dtype=torch.float32):
    """Pixel-centre NDC coords flattened row-major (top row first):
    row r has y = (S-1-2r) * (1/S), column c has x = (2c+1-S) * (1/S).
    Returns (S*S,) xp and (S*S,) yp.

    The rasterizer's divisions by a constant are multiplications by its
    float32 reciprocal, here, in reference.py and in the CUDA kernels alike,
    so all of them round identically on every device."""
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


def face_order(face_verts: torch.Tensor, n_bands: int = N_BANDS
               ) -> torch.Tensor:
    """(B, F) face permutation of the sort: key y-band of the bbox centre
    plus 0.25 x its x in [0, 1] (pallas_raster.py:110,136-144), ascending
    and stable, as jnp.argsort is."""
    fv = face_verts.detach()
    ycen = (fv[..., 1].amin(-1) + fv[..., 1].amax(-1)) * 0.5
    xcen = (fv[..., 0].amin(-1) + fv[..., 0].amax(-1)) * 0.5
    xn = torch.clamp((xcen + 1.0) * 0.5, 0.0, 1.0)
    key = torch.floor((ycen + 1.0) * (n_bands / 2.0)) + 0.25 * xn
    return torch.argsort(key, dim=-1, stable=True)


def pack_constants(face_verts: torch.Tensor, soft_tex: torch.Tensor,
                   hard_tex: torch.Tensor, sort_faces: bool = True,
                   surf_tex: torch.Tensor | None = None,
                   n_bands: int = N_BANDS) -> torch.Tensor:
    """(B, F, 3, 3) verts + per-corner textures -> (B, F_pad, K) float32 in
    the slot layout above (pallas_raster.py:114-188).

    sort_faces orders the faces by face_order; F_pad is F rounded up to a
    multiple of FF, with inert padding faces (|p - v0|^2 offset and bbox
    1e9, z = 1). surf_tex (B, F, R^2, 3), when given, appends the surface
    texel grids at S_SURF and K becomes k_for(R). Unused slots are zero.
    Differentiable in the vertices, the soft texture and the texels: the
    gather's gradient un-sorts them. The hard texture is detached, as in
    pallas_raster.py:165 (the match render takes no gradient)."""
    b, f = face_verts.shape[:2]
    f_pad = -(-f // FF) * FF
    hard_tex = hard_tex.detach()
    if sort_faces and f > 0:
        order = face_order(face_verts, n_bands)

        def take(a):
            idx = order.reshape(b, f, *([1] * (a.dim() - 2)))
            return torch.take_along_dim(a, idx, dim=1)
        face_verts, soft_tex, hard_tex = (take(face_verts), take(soft_tex),
                                          take(hard_tex))
        if surf_tex is not None:
            surf_tex = take(surf_tex)
    c = pack_face_constants(face_verts)
    cols = [c.w_a.reshape(b, f, 9), c.seg.reshape(b, f, 9), c.e2,
            c.pc.reshape(b, f, 9), c.inv_z, c.z, c.front[..., None], c.bbox,
            soft_tex.reshape(b, f, 9), hard_tex.reshape(b, f, 9)]
    tex_res = 0
    if surf_tex is not None:
        tex_res = math.isqrt(surf_tex.shape[2])
        if tex_res * tex_res != surf_tex.shape[2]:
            raise ValueError(f"surf_tex must be (B, F, R^2, 3), got "
                             f"{tuple(surf_tex.shape)}")
        cols.append(surf_tex.reshape(b, f, -1))
    k_tot = k_for(tex_res)
    packed = torch.cat(cols, dim=-1).to(torch.float32)
    packed = torch.nn.functional.pad(packed, (0, k_tot - packed.shape[-1]))
    if f_pad != f:
        filler = torch.zeros((b, f_pad - f, k_tot), dtype=torch.float32,
                             device=packed.device)
        filler[..., S_PC + 2:S_PC + 9:3] = _BIG   # slots S_PC + 2, 5, 8
        filler[..., S_BBOX:S_BBOX + 4] = _BIG
        filler[..., S_IZ:S_IZ + 3] = 1.0
        filler[..., S_Z:S_Z + 3] = 1.0
        packed = torch.cat([packed, filler], dim=1)
    return packed.contiguous()
