"""Public rasterizer API (counterpart of selfcorr_tpu/ops/rasterizer/api.py).

render_fused(face_verts, soft_tex, hard_tex, image_size) packs the per-face
constants and runs the fused forward through `RasterFused`, an autograd
function whose backward is the fused backward: on CUDA tensors the
hand-written kernels (kernel.py: B1 forward, B2 backward) always; on CPU
tensors the plain PyTorch versions (reference.py). There is no fallback from
one to the other. Autograd through the differentiable packing
(common.pack_constants) turns d/d(constants) into vertex and texture
gradients, as the JAX custom VJP does (pallas_raster.py:1393-1432).

Both follow the Pallas kernels' semantics, including gamma_d and gamma_t;
the JAX package's dense CPU path ignores the gammas.
"""
from __future__ import annotations

import torch

from selfcorr_tpu_torch.ops.rasterizer import common as C
from selfcorr_tpu_torch.ops.rasterizer import kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import (
    BWD_GRADS, BWD_PLANES, raster_fused_bwd_plain, raster_fused_fwd_plain)

# the planes RasterFused returns; the last three (match) take no gradient
OUTPUTS = ("alpha1", "alpha2", "depth", "texr", "texg", "texb",
           "matr", "matg", "matb")


def _route(consts, cuda_fn, plain_fn, *args):
    if consts.device.type == "cuda":
        return cuda_fn(consts, *args)
    if consts.device.type == "cpu":
        return plain_fn(consts, *args)
    raise ValueError(f"no fused rasterizer for device {consts.device}")


def raster_fused_fwd(consts: torch.Tensor, image_size: int,
                     sigma1: float = 1e-4, sigma2: float = 1e-3,
                     gamma_d: float = 1e-4, gamma_t: float = 1e-2) -> dict:
    """Packed constants (B, F, 64) -> the 13 (B, S, S) forward planes."""
    return _route(consts, kernel.raster_fused_fwd_cuda,
                  raster_fused_fwd_plain, image_size, sigma1, sigma2,
                  gamma_d, gamma_t)


def raster_fused_bwd(consts: torch.Tensor, planes: dict, grads: dict,
                     image_size: int, sigma1: float = 1e-4,
                     sigma2: float = 1e-3, gamma_d: float = 1e-4,
                     gamma_t: float = 1e-2) -> torch.Tensor:
    """d/d(consts) (B, F, 64) from the forward planes and the cotangents."""
    return _route(consts, kernel.raster_fused_bwd_cuda,
                  raster_fused_bwd_plain, planes, grads, image_size, sigma1,
                  sigma2, gamma_d, gamma_t)


class RasterFused(torch.autograd.Function):
    """consts (B, F, 64) -> the 9 planes of OUTPUTS. Saves the constants and
    the forward's residual planes; the backward is one fused-backward
    call."""

    @staticmethod
    def forward(ctx, consts, image_size, sigma1, sigma2, gamma_d, gamma_t):
        args = (image_size, sigma1, sigma2, gamma_d, gamma_t)
        planes = raster_fused_fwd(consts, *args)
        ctx.args = args
        ctx.save_for_backward(consts, *(planes[n] for n in BWD_PLANES))
        outs = tuple(planes[n] for n in OUTPUTS)
        ctx.mark_non_differentiable(*outs[6:])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        consts, *res = ctx.saved_tensors
        planes = dict(zip(BWD_PLANES, res))
        zero = torch.zeros_like(planes["alpha1"])
        grads = {n: (g if g is not None else zero)
                 for n, g in zip(BWD_GRADS, gouts)}
        dconsts = raster_fused_bwd(consts, planes, grads, *ctx.args)
        return (dconsts,) + (None,) * 5


def render_fused(face_verts: torch.Tensor, soft_tex: torch.Tensor,
                 hard_tex: torch.Tensor, image_size: int,
                 sigma1: float = 1e-4, sigma2: float = 1e-3,
                 gamma_d: float = 1e-4, gamma_t: float = 1e-2) -> dict:
    """Fused render. face_verts (B, F, 3, 3) in rasterizer space
    (z = camera z + EYE_OFFSET); textures (B, F, 3 corners, 3 rgb).

    Returns alpha1, alpha2, depth (camera z) as (B, S, S) and tex, match as
    (B, S, S, 3). Differentiable in face_verts and soft_tex."""
    consts = C.pack_constants(face_verts, soft_tex, hard_tex)
    out = dict(zip(OUTPUTS, RasterFused.apply(
        consts, image_size, sigma1, sigma2, gamma_d, gamma_t)))
    return {
        "alpha1": out["alpha1"],
        "alpha2": out["alpha2"],
        "depth": out["depth"],
        "tex": torch.stack([out["texr"], out["texg"], out["texb"]], -1),
        "match": torch.stack([out["matr"], out["matg"], out["matb"]], -1),
    }
