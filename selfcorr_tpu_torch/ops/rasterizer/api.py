"""Public rasterizer API (counterpart of selfcorr_tpu/ops/rasterizer/api.py).

render_fused(face_verts, soft_tex, hard_tex, image_size) packs the per-face
constants and runs the fused forward: on CUDA tensors the hand-written
kernel (kernel.py) always; on CPU tensors the plain PyTorch version
(reference.py). There is no fallback from one to the other.

Both follow the Pallas kernel's semantics, including gamma_d and gamma_t;
the JAX package's dense CPU path ignores the gammas.
"""
from __future__ import annotations

import torch

from selfcorr_tpu_torch.ops.rasterizer import common as C
from selfcorr_tpu_torch.ops.rasterizer import kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import raster_fused_fwd_plain


def raster_fused_fwd(consts: torch.Tensor, image_size: int,
                     sigma1: float = 1e-4, sigma2: float = 1e-3,
                     gamma_d: float = 1e-4, gamma_t: float = 1e-2) -> dict:
    """Packed constants (B, F, 64) -> the 13 (B, S, S) forward planes."""
    args = (consts, image_size, sigma1, sigma2, gamma_d, gamma_t)
    if consts.device.type == "cuda":
        return kernel.raster_fused_fwd_cuda(*args)
    if consts.device.type == "cpu":
        return raster_fused_fwd_plain(*args)
    raise ValueError(f"no fused rasterizer for device {consts.device}")


def render_fused(face_verts: torch.Tensor, soft_tex: torch.Tensor,
                 hard_tex: torch.Tensor, image_size: int,
                 sigma1: float = 1e-4, sigma2: float = 1e-3,
                 gamma_d: float = 1e-4, gamma_t: float = 1e-2) -> dict:
    """Fused render. face_verts (B, F, 3, 3) in rasterizer space
    (z = camera z + EYE_OFFSET); textures (B, F, 3 corners, 3 rgb).

    Returns alpha1, alpha2, depth (camera z) as (B, S, S) and tex, match as
    (B, S, S, 3)."""
    consts = C.pack_constants(face_verts, soft_tex, hard_tex)
    out = raster_fused_fwd(consts, image_size, sigma1, sigma2, gamma_d,
                           gamma_t)
    return {
        "alpha1": out["alpha1"],
        "alpha2": out["alpha2"],
        "depth": out["depth"],
        "tex": torch.stack([out["texr"], out["texg"], out["texb"]], -1),
        "match": torch.stack([out["matr"], out["matg"], out["matb"]], -1),
    }
