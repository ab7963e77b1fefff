"""Nearest-neighbour and one-way chamfer distances (counterpart of
selfcorr_tpu/ops/knn.py). Plain PyTorch: the JAX package computes these
outside any Pallas kernel, with XLA."""
from __future__ import annotations

import torch


def min_sq_dist(x: torch.Tensor, y: torch.Tensor,
                y_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point squared distance from x (B, N, 3) to its nearest point of
    y (B, M, 3); y_valid (B, M) masks y. Returns (B, N).

    The nearest index comes from |x|^2 + |y|^2 - 2 x.y without gradient;
    the distance is then recomputed exactly from the gathered winner, so the
    gradient is that of a min with the argmin held fixed."""
    with torch.no_grad():
        xs, ys = x.detach().float(), y.detach().float()
        d2v = ((xs * xs).sum(-1)[:, :, None] + (ys * ys).sum(-1)[:, None, :]
               - 2.0 * torch.matmul(xs, ys.transpose(1, 2)))
        if y_valid is not None:
            d2v = torch.where(y_valid[:, None, :] > 0, d2v, float("inf"))
        idx = d2v.argmin(dim=-1)
    ynn = torch.gather(y.float(), 1, idx[..., None].expand(-1, -1, 3))
    out = ((x.float() - ynn) ** 2).sum(-1)
    if y_valid is not None:
        vnn = torch.gather(y_valid.float(), 1, idx)
        out = torch.where(vnn > 0, out, float("inf"))
    return torch.clamp(out, min=0.0)


def chamfer_single_way(x, y, x_valid=None, y_valid=None,
                       point_reduction: str | None = "mean",
                       batch_reduction: str | None = "mean"):
    """One-way chamfer: mean over x of the squared distance to the nearest
    y, then mean over the batch."""
    d2 = min_sq_dist(x, y, y_valid)
    if x_valid is not None:
        d2 = d2 * x_valid.to(d2.dtype)
        denom = torch.clamp(x_valid.sum(-1), min=1.0)
    else:
        denom = x.shape[1]
    if point_reduction is None:
        return d2
    per_batch = d2.sum(-1) / denom
    if batch_reduction is None:
        return per_batch
    return per_batch.mean()
