"""The reference's fused rasterizer: the port's api.py with the plain
versions (reference.py) on every device, in place of kernels B1 / B2
(compact) and B1' / B2' (dense-chunk). render_fused packs the per-face
constants and runs `RasterFused`, whose backward is the plain fused
backward, a transcription of the kernels' per-pair chain.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.ops.rasterizer import common as C
from benchmark.reference.ops.rasterizer import reference as R
from benchmark.reference.ops.rasterizer.chunks import compute_chunk_info

# the planes RasterFused returns; the last three (match) take no gradient
OUTPUTS = ("alpha1", "alpha2", "depth", "texr", "texg", "texb",
           "matr", "matg", "matb")

# the schedule of render_fused: True compact (B1 / B2), False dense-chunk
# (B1' / B2'); a default, read at each call
COMPACT = True


def compact_for(image_size: int) -> bool:
    """The schedule at this image size: the module default (the JAX
    package gates only on its module default too, pallas_raster.py:229)."""
    del image_size
    return COMPACT


def cull_pad(sigma1: float, sigma2: float) -> float:
    """Bbox cull radius (the port's kernel.cull_pad)."""
    return math.sqrt(max(sigma1, sigma2) * C.DIST_CUT) * 1.001 + 1e-6


def chunk_info(consts: torch.Tensor, image_size: int, sigma1: float,
               sigma2: float):
    """spans, masks of the dense-chunk schedule, culled at the compact
    kernels' radius (kernel.cull_pad: the JAX radius sqrt(sigma2 DIST_CUT)
    with a margin for rounding)."""
    return compute_chunk_info(consts, image_size,
                              cull_pad(sigma1, sigma2))


def raster_fused_fwd(consts: torch.Tensor, image_size: int,
                     sigma1: float = 1e-4, sigma2: float = 1e-3,
                     gamma_d: float = 1e-4, gamma_t: float = 1e-2,
                     tex_res: int = 0, chunks=None) -> dict:
    """Packed constants (B, F, K) -> the 13 (B, S, S) forward planes: the
    compact schedule, or the dense-chunk one when given chunks = (spans,
    masks)."""
    args = (image_size, sigma1, sigma2, gamma_d, gamma_t, tex_res)
    if chunks is None:
        return R.raster_fused_fwd_plain(consts, *args)
    return R.raster_fused_fwd_chunk_plain(consts, *chunks, *args)


def raster_fused_bwd(consts: torch.Tensor, planes: dict, grads: dict,
                     image_size: int, sigma1: float = 1e-4,
                     sigma2: float = 1e-3, gamma_d: float = 1e-4,
                     gamma_t: float = 1e-2, tex_res: int = 0,
                     chunks=None) -> torch.Tensor:
    """d/d(consts) (B, F, K) from the forward planes and the cotangents, in
    the schedule raster_fused_fwd took."""
    args = (planes, grads, image_size, sigma1, sigma2, gamma_d, gamma_t,
            tex_res)
    if chunks is None:
        return R.raster_fused_bwd_plain(consts, *args)
    return R.raster_fused_bwd_chunk_plain(consts, *chunks, *args)


class RasterFused(torch.autograd.Function):
    """consts (B, F, K) -> the 9 planes of OUTPUTS, in the compact or the
    dense-chunk schedule. Saves the constants, the forward's residual planes
    and the chunk cull; the backward is one fused-backward call."""

    @staticmethod
    def forward(ctx, consts, image_size, sigma1, sigma2, gamma_d, gamma_t,
                tex_res=0, compact=True):
        args = (image_size, sigma1, sigma2, gamma_d, gamma_t, tex_res)
        chunks = None if compact else chunk_info(consts, image_size, sigma1,
                                                 sigma2)
        planes = raster_fused_fwd(consts, *args, chunks=chunks)
        ctx.args = args
        ctx.save_for_backward(consts, *(chunks or ()),
                              *(planes[n] for n in R.BWD_PLANES))
        ctx.compact = compact
        outs = tuple(planes[n] for n in OUTPUTS)
        ctx.mark_non_differentiable(*outs[6:])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        consts, *res = ctx.saved_tensors
        chunks = None
        if not ctx.compact:
            chunks, res = res[:2], res[2:]
        planes = dict(zip(R.BWD_PLANES, res))
        zero = torch.zeros_like(planes["alpha1"])
        grads = {n: (g if g is not None else zero)
                 for n, g in zip(R.BWD_GRADS, gouts)}
        dconsts = raster_fused_bwd(consts, planes, grads, *ctx.args,
                                   chunks=chunks)
        return (dconsts,) + (None,) * 7


def render_fused(face_verts: torch.Tensor, soft_tex: torch.Tensor,
                 hard_tex: torch.Tensor, image_size: int,
                 sigma1: float = 1e-4, sigma2: float = 1e-3,
                 gamma_d: float = 1e-4, gamma_t: float = 1e-2,
                 surf_tex: torch.Tensor | None = None) -> dict:
    """Fused render. face_verts (B, F, 3, 3) in rasterizer space
    (z = camera z + EYE_OFFSET); textures (B, F, 3 corners, 3 rgb).
    surf_tex (B, F, R^2, 3), when given, switches the texture pass to the
    per-face texel grids ('surface' mode); soft_tex then takes no part.

    Returns alpha1, alpha2, depth (camera z) as (B, S, S) and tex, match as
    (B, S, S, 3). Differentiable in face_verts, soft_tex and surf_tex."""
    tex_res = 0 if surf_tex is None else math.isqrt(surf_tex.shape[2])
    consts = C.pack_constants(face_verts, soft_tex, hard_tex,
                              surf_tex=surf_tex,
                              n_bands=C.bands_for(image_size))
    out = dict(zip(OUTPUTS, RasterFused.apply(
        consts, image_size, sigma1, sigma2, gamma_d, gamma_t, tex_res,
        compact_for(image_size))))
    return {
        "alpha1": out["alpha1"],
        "alpha2": out["alpha2"],
        "depth": out["depth"],
        "tex": torch.stack([out["texr"], out["texg"], out["texb"]], -1),
        "match": torch.stack([out["matr"], out["matg"], out["matb"]], -1),
    }
