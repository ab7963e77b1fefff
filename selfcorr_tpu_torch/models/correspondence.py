"""Dense 2D <-> 3D correspondence by masked dual softmax (counterpart of
selfcorr_tpu/models/correspondence.py:24-79).

Conventions: image features (B, P, C) row-major pixels; mesh features
(B, N, C); pointcorr (B, P, N); imatch (B, N, 2) xy in [-1, 1]; match maps
NHWC. Off-mask pixels are filled with -1e5 before the softmaxes. The cost
volume is a plain batched matmul, as in the JAX package.
"""
from __future__ import annotations

import torch

from selfcorr_tpu_torch.ops.image_ops import resize_bilinear, resize_nearest

NEG = -1e5


def make_meshgrid(hf: int, wf: int, device=None) -> torch.Tensor:
    """(P, 2) pixel-centre coords in [-1, 1], row-major; both axes
    normalized by wf / 2 as the reference does."""
    yy, xx = torch.meshgrid(torch.arange(hf, dtype=torch.float32,
                                         device=device),
                            torch.arange(wf, dtype=torch.float32,
                                         device=device), indexing="ij")
    grid = torch.stack([xx, yy], -1).reshape(-1, 2) + 0.5
    return grid / (wf / 2.0) - 1.0


def masked_cost_volume(img_feat, mesh_feat, mask_down):
    """pointcorr (B, P, N) = img_feat . mesh_feat, off-mask rows -> -1e5."""
    pc = torch.matmul(img_feat, mesh_feat.transpose(1, 2))
    on = (mask_down > 0)[..., None]
    return pc * on + NEG * (~on)


def dual_softmax_match(img_feat, mesh_feat, mask, pred_v, meshgrid,
                       tau_img: float, tau_mesh: float, hf: int, wf: int,
                       compute_conf: bool = False):
    """Returns (pointcorr, match_map (B, H, W, 3), imatch (B, N, 2),
    match_conf (B, H, W) or None).

    match_conf is the forward-backward cycle confidence: each pixel's 3D
    match -> its nearest vertex -> that vertex's imatch -> distance back to
    the pixel, exp(-5 err), bilinearly upsampled, zeroed below the masked
    mean over the WHOLE batch (capped at 0.5) as the JAX package does."""
    b, h, w = mask.shape
    mask_down = resize_nearest(mask[..., None], (hf, wf)).reshape(b, -1)
    pointcorr = masked_cost_volume(img_feat, mesh_feat, mask_down)

    pc_mesh = torch.softmax(tau_mesh * pointcorr, dim=1)
    pc_img = torch.softmax(tau_img * pointcorr, dim=2)
    imatch = torch.einsum("bpn,pk->bnk", pc_mesh, meshgrid)
    match = torch.matmul(pc_img, pred_v.detach())            # (B, P, 3)

    match_conf = None
    if compute_conf:
        d2 = ((match ** 2).sum(-1)[:, :, None]
              + (pred_v ** 2).sum(-1)[:, None, :]
              - 2 * torch.matmul(match, pred_v.transpose(1, 2)))
        nearest = d2.argmin(dim=-1)
        ipred = torch.gather(imatch, 1, nearest[..., None].expand(-1, -1, 2))
        fberr = torch.linalg.vector_norm(meshgrid[None] - ipred, dim=-1)
        conf = torch.exp(-5.0 * fberr).reshape(b, hf, wf)
        conf = resize_bilinear(conf[..., None], (h, w))[..., 0]
        on = mask > 0
        msum = torch.clamp(on.sum(), min=1)
        cmean = torch.clamp((conf * on).sum() / msum, max=0.5)
        match_conf = torch.where(conf < cmean, 0.0, conf)

    match_map = resize_nearest(match.reshape(b, hf, wf, 3), (h, w))
    return pointcorr, match_map, imatch, match_conf
