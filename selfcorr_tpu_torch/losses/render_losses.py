"""Rendering-supervision losses: mask pyramid, texture, depth (counterpart
of selfcorr_tpu/losses/render_losses.py). Maps are NHWC, (B, H, W) for one
channel; every loss returns per-batch-element values (B,)."""
from __future__ import annotations

import torch

from selfcorr_tpu_torch.ops.geometry import depth_to_point_cloud
from selfcorr_tpu_torch.ops.image_ops import downsample_area, upsample_repeat
from selfcorr_tpu_torch.ops.knn import min_sq_dist
from selfcorr_tpu_torch.ops.mesh_ops import sample_surface


def mask_pyramid_loss(mask_gt, mask_pred, occ=None):
    """0.2 * sum over 5 scales of the upsampled squared difference of the
    area-downsampled masks, averaged over pixels. Returns (B,)."""
    total = 0.0
    for i in range(5):
        f = 2 ** i
        diff = (downsample_area(mask_pred[..., None], f)
                - downsample_area(mask_gt[..., None], f)) ** 2
        total = total + upsample_repeat(diff, f)[..., 0]
    if occ is not None:
        total = total * (1.0 - occ)
    return 0.2 * total.mean(dim=(1, 2))


def texture_loss(img, mask, tex_pred, tex_mask, occ=None):
    """0.75 * masked L2 (black background) + L1 against the white-background
    composite. img, tex_pred (B, H, W, 3). Returns (B,)."""
    m = (mask > 0).to(img.dtype)[..., None]
    img_black = img * m
    pred_black = tex_pred * tex_mask[..., None]
    img_white = 1.0 - m + img_black
    l2 = ((img_black - pred_black) ** 2).sum(-1)
    l1 = torch.abs(img_white - tex_pred).mean(-1)
    per_pix = 0.75 * l2 + l1
    if occ is not None:
        per_pix = per_pix * (1.0 - occ)
    return per_pix.mean(dim=(1, 2))


def _depth_scale(depth_gt, depth_pred, depth_mask, mask):
    """The batch-global ratio of the rendered to the measured mean depth."""
    dm = (depth_mask != 0).to(depth_pred.dtype)
    gm = ((mask * depth_gt) != 0).to(depth_pred.dtype)
    pred_mean = (depth_pred * dm).sum() / torch.clamp(dm.sum(), min=1.0)
    gt_mean = (depth_gt * gm).sum() / torch.clamp(gm.sum(), min=1.0)
    return pred_mean / torch.clamp(gt_mean, min=1e-12), dm


def depth_loss(depth_gt, depth_pred, depth_mask, mask, thresh: float = 1.0):
    """Scale-matched squared depth difference clamped at `thresh`; the scale
    is one scalar over the whole batch. Returns ((B,), diff map)."""
    scale, dm = _depth_scale(depth_gt, depth_pred, depth_mask, mask)
    diff = depth_pred - scale * depth_gt
    keep = ((mask * dm) != 0) & (depth_gt != 0)
    diff = torch.where(keep, diff, 0.0)
    sq = diff ** 2
    clamped = thresh - torch.clamp(thresh - sq, min=0.0)  # min(sq, thresh)
    return clamped.mean(dim=(1, 2)), diff


def depth_loss_chamfer(pred_v, faces, depth_gt, depth_pred, depth_mask,
                       mask, pp, foc, rotation, translation,
                       n_pts: int = 2000, u=None, ub=None, generator=None):
    """Chamfer variant of the depth loss: the scale-matched depth map is
    back-projected, moved to the object frame, and each point pays its
    squared distance to the nearest of `n_pts` surface samples of the
    predicted mesh (draws u, ub as in sample_surface). Returns ((B,), diff
    map)."""
    b, h, w = depth_gt.shape
    scale, dm = _depth_scale(depth_gt, depth_pred, depth_mask, mask)
    scale = scale.detach()
    depth_s = depth_gt * scale
    diff = depth_pred - depth_s
    diff = torch.where(((mask * dm) != 0) & (depth_s != 0), diff, 0.0)
    pc = depth_to_point_cloud(depth_s, pp, foc)
    pc = torch.einsum("bnc,bdc->bnd", pc - translation, rotation).detach()
    samples = sample_surface(pred_v, faces, n_pts, u=u, ub=ub,
                             generator=generator)
    d2 = min_sq_dist(pc, samples).reshape(b, h, w)
    d2 = torch.where((mask != 0) & (depth_gt != 0), d2, 0.0)
    return d2.mean(dim=(1, 2)), diff
