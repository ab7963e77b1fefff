"""Similarity-transform estimation (Umeyama SVD) with batched RANSAC
(counterpart of selfcorr_tpu/ops/umeyama.py).

Every hypothesis of every image is fitted at once with batched
torch.linalg.svd / det. Quirks kept from the reference, as the JAX package
keeps them:
  * the covariance is divided by n, the source variance is unbiased
    (/(n-1)): mixed normalization;
  * a hypothesis is scored by the norm of its residuals over ALL valid
    points, not only its inliers;
  * the inlier threshold is max(|t|/|s|, |s|/|t|) of the mean point norms.
"""
from __future__ import annotations

import torch

from selfcorr_tpu_torch.utils import tracing
from selfcorr_tpu_torch.utils.device import upload


def umeyama_similarity(src, tgt, w):
    """Weighted Umeyama fit in row convention, tgt ~ s * src @ R + t.

    src, tgt (..., N, 3); w (..., N) non-negative weights.
    Returns (scale (...), R (..., 3, 3) row-acting, t (..., 3), ok (...))."""
    w = w.to(src.dtype)
    n = torch.clamp(w.sum(-1), min=1e-6)
    mu_s = (src * w[..., None]).sum(-2) / n[..., None]
    mu_t = (tgt * w[..., None]).sum(-2) / n[..., None]
    ds = src - mu_s[..., None, :]
    cs = ds * w[..., None]
    ct = (tgt - mu_t[..., None, :]) * w[..., None]
    cov = torch.matmul(ct.transpose(-1, -2), ds) / n[..., None, None]
    U, D, Vh = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vh)
    flip = torch.where(det < 0, -1.0, 1.0)
    D = torch.cat([D[..., :2], D[..., 2:] * flip[..., None]], -1)
    U = torch.cat([U[..., :2], U[..., 2:] * flip[..., None, None]], -1)
    R = torch.matmul(U, Vh).transpose(-1, -2)
    var_p = (cs * ds).sum((-1, -2)) / torch.clamp(n - 1.0, min=1e-6)
    scale = D.sum(-1) / torch.clamp(var_p, min=1e-12)
    t = mu_t - scale[..., None] * torch.matmul(mu_s[..., None, :], R)[..., 0, :]
    ok = (n >= 3) & torch.isfinite(scale) & (var_p > 1e-12)
    return scale, R, t, ok


def draw_samples(valid: torch.Tensor, n_iters: int, n_sample: int,
                 generator: torch.Generator | None = None,
                 u: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n_iters, n_sample) indices drawn uniformly, with replacement,
    from each row's valid points, on valid's device: from the uniforms `u`
    in [0, 1) of that shape, else from ones drawn on the CPU from
    `generator`; the uniforms go up in one non-blocking copy.

    Draw u of a row with c valid points (c = 1 for a row with none) picks
    its k-th valid point, k = min(int(u * c), c - 1): the first position
    whose running count of valid points reaches k + 1, which is where a
    stable sort of ~valid puts it. A row with no valid point gives
    position 0, as that sort does. Nothing waits for the device."""
    with tracing.span("umeyama.draw"):
        b, n = valid.shape
        if u is None:
            u = torch.rand((b, n_iters, n_sample), generator=generator)
        (u,) = upload([u], valid.device)
        count = valid.sum(-1).clamp(min=1)
        k = (u * count[:, None, None]).long().minimum(
            count[:, None, None] - 1)
        seen = valid.cumsum(-1)                 # valid points up to each
        idx = torch.searchsorted(seen, (k + 1).reshape(b, -1))
        idx = torch.where(idx < n, idx, 0)      # a row with none
        return idx.reshape(b, n_iters, n_sample)


def ransac_umeyama_batch(src, tgt, valid, n_iters: int = 100,
                         n_sample: int = 5, sample_idx=None,
                         generator: torch.Generator | None = None,
                         sample_u=None) -> dict:
    """Fixed-shape RANSAC + final inlier refit for a batch of point sets.

    src, tgt (B, N, 3); valid (B, N) bool; sample_idx (B, n_iters,
    n_sample) the minimal samples, else drawn (draw_samples) from the
    uniforms sample_u of that shape or from `generator`.
    Returns dict(scale, R, t, inlier_ratio, ok), batched over B."""
    src = src.float()
    tgt = tgt.float()
    b = src.shape[0]
    vw = valid.float()
    n_valid = torch.clamp(vw.sum(-1), min=1e-6)
    tgt_norm = (torch.linalg.vector_norm(tgt, dim=-1) * vw).sum(-1) / n_valid
    src_norm = (torch.linalg.vector_norm(src, dim=-1) * vw).sum(-1) / n_valid
    pass_t = torch.maximum(tgt_norm / torch.clamp(src_norm, min=1e-12),
                           src_norm / torch.clamp(tgt_norm, min=1e-12))

    if sample_idx is None:
        if generator is None and sample_u is None:
            raise ValueError("ransac needs sample_idx, sample_u or a "
                             "generator")
        sample_idx = draw_samples(valid, n_iters, n_sample, generator,
                                  sample_u)
    (sample_idx,) = upload([sample_idx.long()], src.device)
    flat = sample_idx.reshape(b, -1, 1).expand(-1, -1, 3)
    s_pts = torch.gather(src, 1, flat).reshape(b, n_iters, n_sample, 3)
    t_pts = torch.gather(tgt, 1, flat).reshape(b, n_iters, n_sample, 3)
    scale, R, t, ok = umeyama_similarity(
        s_pts, t_pts, torch.ones(s_pts.shape[:-1], device=src.device))

    pred = scale[..., None, None] * torch.matmul(src[:, None], R) \
        + t[:, :, None, :]                                  # (B, I, N, 3)
    res = torch.linalg.vector_norm(tgt[:, None] - pred, dim=-1)
    res = torch.where(valid[:, None], res, 0.0)
    score = torch.linalg.vector_norm(res, dim=-1)           # (B, I)
    inliers = (res < pass_t[:, None, None]) & valid[:, None]
    score = torch.where(ok & torch.isfinite(score), score, float("inf"))
    best = score.argmin(dim=-1)                             # first on ties
    best_inl = inliers[torch.arange(b, device=src.device), best]
    inlier_ratio = best_inl.sum(-1) / n_valid

    scale_f, R_f, t_f, ok_f = umeyama_similarity(src, tgt, best_inl.float())
    best_score = torch.gather(score, 1, best[:, None])[:, 0]
    ok_f = ok_f & (inlier_ratio >= 0.1) & torch.isfinite(best_score)
    return {"scale": scale_f, "R": R_f, "t": t_f,
            "inlier_ratio": inlier_ratio, "ok": ok_f}
