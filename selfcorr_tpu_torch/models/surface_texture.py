"""Per-face surface textures, the 'surface' texture mode of the training
render (counterpart of selfcorr_tpu/models/surface_texture.py; off in every
shipped config, on with --surface_texture).

A deterministic barycentric pattern of n^2 points per face (upper / lower
triangle fold), the face-corner image matches interpolated at those points,
and the image colours grid-sampled there give (B, F, n^2, 3) texel grids.
The fused render (ops/rasterizer, render_fused(surf_tex=)) takes the texel
each pixel falls in instead of the interpolated vertex colour.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from selfcorr_tpu_torch.ops.image_ops import grid_sample


def barycentric_pattern(n: int) -> np.ndarray:
    """(n^2, 2) deterministic (u, v) weights over edges (v1 - v0),
    (v2 - v0), with the points below the diagonal folded above it."""
    xx = np.zeros(n * n)
    yy = np.tile(np.arange((2 * n - 1) / (2.0 * n), 0, -1.0 / n), n)
    for i in range(n):
        xx[i * n:(i + 1) * n] = (2 * i + 1) / (2.0 * n)
        yy[i * n:(i + 1) * n] -= i / (1.0 * n)
    fold = yy < 0
    xx[fold] = 1 - xx[fold]
    yy[fold] *= -1
    return np.stack([xx, yy], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pattern_on(n: int, device: torch.device) -> torch.Tensor:
    """barycentric_pattern(n) on `device`, made there once."""
    return torch.as_tensor(barycentric_pattern(n), device=device)


def surface_texture(img: torch.Tensor, imatch: torch.Tensor,
                    faces: torch.Tensor, n: int = 6) -> torch.Tensor:
    """img (B, H, W, 3); imatch (B, V, 2) NDC; faces (F, 3) long ->
    (B, F, n^2, 3)."""
    b = img.shape[0]
    pat = _pattern_on(n, img.device)
    fm = imatch[:, faces]                             # (B, F, 3, 2)
    m0 = fm[:, :, 0]                                  # (B, F, 2)
    e1 = fm[:, :, 1] - m0
    e2 = fm[:, :, 2] - m0
    pts = (m0[:, :, None]
           + pat[None, None, :, 0:1] * e1[:, :, None]
           + pat[None, None, :, 1:2] * e2[:, :, None])  # (B, F, n^2, 2)
    f, s2 = pts.shape[1], pts.shape[2]
    colors = grid_sample(img, pts.reshape(b, f * s2, 2))
    return colors.reshape(b, f, s2, 3)


def sample_surface_texture(tex: torch.Tensor, w0, w1, w2, res: int
                           ) -> torch.Tensor:
    """Texel lookup at barycentric weights: cell (trunc(w0 R), trunc(w1 R))
    clipped to the grid, folded when the cell crosses the diagonal. tex
    (..., R^2, 3); w* broadcastable to tex's leading dims -> (..., 3)."""
    del w2
    wx = torch.clamp((w0 * res).to(torch.int64), 0, res - 1)
    wy = torch.clamp((w1 * res).to(torch.int64), 0, res - 1)
    upper = ((w0 + w1) * res - wx - wy) <= 1
    idx = torch.where(upper, wy * res + wx,
                      (res - 1 - wy) * res + (res - 1 - wx))
    idx = idx[..., None, None].expand(*idx.shape, 1, tex.shape[-1])
    return torch.take_along_dim(tex, idx, dim=-2)[..., 0, :]
