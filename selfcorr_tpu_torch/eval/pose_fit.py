"""Whole-batch pose fitting (counterpart of selfcorr_tpu/eval/pose_fit.py):
pixel selection, depth back-projection, the batched RANSAC-Umeyama fit and
the fitted boxes, with static shapes (a top-k pixel budget instead of
boolean indexing). The fallback pose on failure is identity R,
t = (0, 0, 500) mm, scale 100."""
from __future__ import annotations

import torch

from selfcorr_tpu_torch.ops.umeyama import ransac_umeyama_batch


def pixel_grid_ndc(h: int, w: int, device=None) -> torch.Tensor:
    """Full-res pixel-centre grid in [-1, 1], both axes over w / 2;
    (h, w, 2)."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    grid = torch.stack([xx, yy], -1) + 0.5
    return grid / (w / 2.0) - 1.0


def select_points(match_conf, depth, mask, max_points: int):
    """Top-`max_points` pixels by mask weight (+ conf tiebreak). lax.top_k
    keeps lower indices first on ties, so the order is a STABLE descending
    sort. Returns (idx (B, K) long, valid (B, K) bool)."""
    b = depth.shape[0]
    weight = ((depth > 0) & (mask > 0) & (match_conf > 0)).float()
    flat_w = weight.reshape(b, -1)
    score = flat_w * (1.0 + match_conf.reshape(b, -1))
    idx = torch.sort(score, dim=1, descending=True,
                     stable=True).indices[:, :max_points]
    return idx, torch.gather(flat_w, 1, idx) > 0


@torch.no_grad()
def fit_poses(match, match_conf, depth, mask, pp_crop, foc_crop, pred_v,
              base_rot, max_points: int = 16384, n_iters: int = 100,
              sample_idx=None, generator=None, sample_u=None) -> dict:
    """match (B, H, W, 3) canonical coords; depth / mask / conf (B, H, W);
    NDC intrinsics (B, 2); pred_v (B, N, 3); base_rot (3, 3).
    sample_idx (B, n_iters, 5) RANSAC draws, else drawn from the uniforms
    sample_u (B, n_iters, 5) or from `generator`.

    Returns dict(bbox9, verts, rotation, translation, scale_fit, size, ok).
    """
    b, h, w = depth.shape
    dev = depth.device
    max_points = min(max_points, h * w)
    grid = pixel_grid_ndc(h, w, device=dev).reshape(-1, 2)
    idx, valid = select_points(match_conf, depth, mask, max_points)

    src = torch.gather(match.reshape(b, -1, 3), 1,
                       idx[..., None].expand(-1, -1, 3))
    z = torch.gather(depth.reshape(b, -1), 1, idx)
    uv = grid[idx]                                          # (B, K, 2)
    x = (uv[..., 0] - pp_crop[:, None, 0]) * z / foc_crop[:, None, 0]
    y = (uv[..., 1] - pp_crop[:, None, 1]) * z / foc_crop[:, None, 1]
    tgt = torch.stack([x, y, z], -1)                        # depth units (mm)

    fit = ransac_umeyama_batch(src, tgt, valid, n_iters=n_iters,
                               sample_idx=sample_idx, generator=generator,
                               sample_u=sample_u)

    ok = fit["ok"] & (valid.sum(-1) >= 5)
    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    rotation = torch.where(ok[:, None, None], fit["R"], eye)
    translation = torch.where(ok[:, None], fit["t"],
                              500.0 * eye[:, 2])            # (0, 0, 500)
    scale = torch.where(ok, fit["scale"], 100.0)
    translation = translation[:, None, :] * 0.001           # mm -> m
    scale_fit = scale[:, None, None] * 0.001

    base_rot = torch.as_tensor(base_rot, dtype=torch.float32, device=dev)
    pred_v_b = torch.einsum("bnc,dc->bnd", pred_v, base_rot)
    rotation = torch.einsum("de,bec->bdc", base_rot, rotation)

    mins = pred_v_b.amin(dim=1)
    maxs = pred_v_b.amax(dim=1)
    ctr = (mins + maxs) / 2.0
    corners = [torch.stack([(maxs if sx else mins)[:, 0],
                            (maxs if sy else mins)[:, 1],
                            (maxs if sz else mins)[:, 2]], -1)
               for sx in (0, 1) for sy in (0, 1) for sz in (0, 1)]
    bbox = torch.stack([ctr] + corners, dim=1)              # (B, 9, 3)
    bbox9 = torch.einsum("bkc,bcd->bkd", bbox * scale_fit, rotation) \
        + translation
    verts = torch.einsum("bnc,bcd->bnd", pred_v_b * scale_fit, rotation) \
        + translation
    size = (maxs - mins) * scale_fit[..., 0]
    return dict(bbox9=bbox9, verts=verts, rotation=rotation,
                translation=translation, scale_fit=scale_fit, size=size,
                ok=ok)
