"""Dense 2D <-> 3D correspondence by masked dual softmax, the
rotation-augmentation cycle loss and the frozen-DINO cycle loss
(counterpart of selfcorr_tpu/models/correspondence.py).

Conventions: image features (B, P, C) row-major pixels; mesh features
(B, N, C); pointcorr (B, P, N); imatch (B, N, 2) xy in [-1, 1]; match maps
NHWC. Off-mask pixels are filled with -1e5 before the softmaxes. Cost
volumes are plain batched matmuls, as in the JAX package.
"""
from __future__ import annotations

import torch

from benchmark.reference.ops.image_ops import (resize_bilinear, resize_nearest,
                                              rotate_fast)

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
                       compute_conf: bool = False, batch_sum=None):
    """Returns (pointcorr, match_map (B, H, W, 3), imatch (B, N, 2),
    match_conf (B, H, W) or None).

    match_conf is the forward-backward cycle confidence: each pixel's 3D
    match -> its nearest vertex -> that vertex's imatch -> distance back to
    the pixel, exp(-5 err), bilinearly upsampled, zeroed below the masked
    mean over the WHOLE batch (capped at 0.5) as the JAX package does.
    batch_sum, when given, sums a tensor over the whole batch where the
    rows are split across ranks (the JAX package's global batch)."""
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
        sums = torch.stack([(conf * on).sum(), on.sum().to(conf.dtype)])
        if batch_sum is not None:
            sums = batch_sum(sums)
        cmean = torch.clamp(sums[0] / torch.clamp(sums[1], min=1), max=0.5)
        match_conf = torch.where(conf < cmean, 0.0, conf)

    match_map = resize_nearest(match.reshape(b, hf, wf, 3), (h, w))
    return pointcorr, match_map, imatch, match_conf


def rotation_angle(generator: torch.Generator) -> torch.Tensor:
    """The rotation cycle's draw: one angle in [0, 360) degrees, on the
    CPU."""
    return torch.rand((), generator=generator) * 360.0


def rotation_cycle_loss(angle, img, mask, img_feat, encode_fn, meshgrid,
                        tau_mesh: float, hf: int, wf: int):
    """Rotation-equivariance cycle loss (selfcorr_tpu/models/
    correspondence.py:82-126): rotate the batch by `angle` degrees (the
    injectable draw, see rotation_angle), re-encode it with encode_fn
    (img (B, H, W, 3) -> normalized features (B, P, C)), match half-res
    features of the original to the rotated frames, and penalize the soft
    argmax's distance from the rotated grid. Returns (loss, cycle_match
    (B, Q, 2), gt (B, Q, 2), tgt_mask (B, Q))."""
    b = img.shape[0]
    h2, w2 = hf // 2, wf // 2
    grid_map = meshgrid.reshape(hf, wf, 2)[None]
    grid_half = resize_bilinear(grid_map, (h2, w2)).expand(b, -1, -1, -1)

    tgt_img = rotate_fast(img, angle, mode="bilinear")
    tgt_mask = rotate_fast(mask[..., None], angle, mode="nearest")[..., 0]
    gt = rotate_fast(grid_map.expand(b, -1, -1, -1), angle, mode="nearest")
    gt = resize_nearest(gt, (h2, w2)).reshape(b, -1, 2)

    tgt_feat = encode_fn(tgt_img)

    def half(feat):
        return resize_nearest(feat.reshape(b, hf, wf, -1),
                              (h2, w2)).reshape(b, h2 * w2, -1)

    src_f = half(img_feat)
    tgt_f = half(tgt_feat)
    src_m = resize_nearest(mask[..., None], (h2, w2)).reshape(b, -1)
    tgt_m = resize_nearest(tgt_mask[..., None], (h2, w2)).reshape(b, -1)

    pc = torch.matmul(src_f, tgt_f.transpose(1, 2))
    pair = (src_m > 0)[:, :, None] & (tgt_m > 0)[:, None, :]
    pc = pc * pair + NEG * (~pair)
    pc_tgt = torch.softmax(tau_mesh * pc, dim=1)             # src per tgt
    cycle_match = torch.einsum("bpq,bpk->bqk", pc_tgt,
                               grid_half.reshape(b, -1, 2))
    err = torch.linalg.vector_norm(cycle_match - gt, dim=-1) * tgt_m
    return err.mean(), cycle_match, gt, tgt_m


def _take(x, idx):
    """x (B, Q, ...) gathered along dim 1 by idx (B, K)."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(shape))


def dino_pair_match(src_feat, tgt_feat, src_mask, tgt_mask, grid, k: int):
    """Mutual-argmax cross-frame matches, the k most cycle-consistent.

    src_feat / tgt_feat (B, Q, C) frozen features; masks (B, H, W) full res;
    grid (B, Q, 2). Returns (pts_src, pts_tgt, idx_src, idx_tgt, mask),
    k entries each. The top k of -dist keep the lower index first on ties,
    as lax.top_k does: a stable sort, since cycle-consistent matches tie at
    distance 0."""
    b, q, _ = src_feat.shape
    side = int(round(q ** 0.5))
    sm = resize_nearest(src_mask[..., None], (side, side)).reshape(b, -1)
    tm = resize_nearest(tgt_mask[..., None], (side, side)).reshape(b, -1)
    pc = torch.matmul(src_feat, tgt_feat.transpose(1, 2))
    pair = (sm > 0)[:, :, None] & (tm > 0)[:, None, :]
    pc = pc * pair + NEG * (~pair)

    bw = pc.argmax(dim=1)        # (B, Q) best src for each tgt
    fw = pc.argmax(dim=2)        # (B, Q) best tgt for each src
    cyc = torch.gather(fw, 1, bw)
    match = _take(grid, bw)
    cycle = _take(grid, cyc)
    dist = torch.linalg.vector_norm(cycle - grid, dim=-1)
    dist = dist * (tm > 0) + 1e5 * (tm <= 0)
    idx = torch.sort(dist, dim=-1, stable=True).indices[:, :k]
    return (_take(match, idx), _take(grid, idx), torch.gather(bw, 1, idx),
            idx, torch.gather(tm, 1, idx))


def _half_grid(meshgrid, b, hf, wf):
    grid_map = meshgrid.reshape(hf, wf, 2)[None]
    grid_half = resize_bilinear(grid_map, (hf // 2, wf // 2))
    return grid_half.expand(b, -1, -1, -1).reshape(b, -1, 2)


def dino_cycle_loss_dense(feat_pairs, mask_pairs, dw_pairs, pc_pairs,
                          meshgrid, tau_img: float, tau_mesh: float,
                          hf: int, wf: int, k: int):
    """Dense oracle of dino_cycle_loss: the reference transport
    (selfcorr_tpu/models/correspondence.py:164-214) with the (B, P, Q)
    correspondence materialized. pc_pairs: the model's full-res pointcorr
    (B, P, N) per side. Returns (loss, vis dict)."""
    src_feat, tgt_feat = feat_pairs
    mask_src, mask_tgt = mask_pairs
    dw_src, dw_tgt = dw_pairs
    pc_src, pc_tgt = pc_pairs
    b = src_feat.shape[0]
    n = pc_src.shape[-1]
    h2, w2 = hf // 2, wf // 2
    grid_half = _half_grid(meshgrid, b, hf, wf)
    pts_src, pts_tgt, _, idx_tgt, mmask = dino_pair_match(
        src_feat, tgt_feat, mask_src, mask_tgt, grid_half, k)

    def half_pc(pc):
        return resize_bilinear(pc.reshape(b, hf, wf, n),
                               (h2, w2)).reshape(b, h2 * w2, n)

    pc_img = torch.softmax(tau_img * half_pc(pc_tgt), dim=2)
    pc_mesh = torch.softmax(tau_mesh * half_pc(pc_src), dim=1)
    pc_img = pc_img * (dw_tgt[:, None, :] >= 0.5)
    pc_mesh = pc_mesh * (dw_src[:, None, :] >= 0.5)
    corr = torch.matmul(pc_mesh, pc_img.transpose(1, 2))      # (B, P, Q)
    corr = corr / (corr.sum(dim=1, keepdim=True) + 1e-5)
    match = torch.einsum("bpq,bpk->bqk", corr, grid_half)
    match_sel = _take(match, idx_tgt)
    loss = (torch.linalg.vector_norm(match_sel - pts_src, dim=-1)
            * mmask).mean()
    return loss, dict(pts_src=pts_src, pts_tgt=pts_tgt, match=match_sel,
                      mask=mmask)


def dino_cycle_loss(feat_pairs, mask_pairs, dw_pairs, imgfeat_pairs,
                    meshfeat_pairs, meshgrid, tau_img: float, tau_mesh: float,
                    hf: int, wf: int, k: int):
    """Transport DINO pixel matches through the model's pointcorr, in the
    factored form of selfcorr_tpu/models/correspondence.py:217-301: the
    bilinear pooling commutes with the feature contraction, only the k
    selected target rows are computed, and the (B, P, Q) correspondence is
    never formed. Equal to dino_cycle_loss_dense up to rounding.

    feat_pairs: frozen DINO features (B, Q, C) per side; imgfeat_pairs /
    meshfeat_pairs: the model's normalized image (B, P, Cm) and mesh
    (B, N, Cm) features per side. Returns (loss, vis dict)."""
    src_feat, tgt_feat = feat_pairs
    mask_src, mask_tgt = mask_pairs
    dw_src, dw_tgt = dw_pairs
    if_src, if_tgt = imgfeat_pairs
    mf_src, mf_tgt = meshfeat_pairs
    b = src_feat.shape[0]
    h2, w2 = hf // 2, wf // 2
    grid_half = _half_grid(meshgrid, b, hf, wf)
    pts_src, pts_tgt, _, idx_tgt, mmask = dino_pair_match(
        src_feat, tgt_feat, mask_src, mask_tgt, grid_half, k)

    def pooled_factors(img_feat, mask):
        """Half-res masked features and off-mask fraction: the pooled cost
        volume is pif @ mesh_feat^T + NEG * poff."""
        on = resize_nearest(mask[..., None], (hf, wf)).reshape(b, -1) > 0
        ifm = (img_feat * on[..., None]).reshape(b, hf, wf, -1)
        pif = resize_bilinear(ifm, (h2, w2)).reshape(b, h2 * w2, -1)
        poff = resize_bilinear((~on).float().reshape(b, hf, wf, 1),
                               (h2, w2)).reshape(b, h2 * w2)
        return pif, poff

    pif_s, poff_s = pooled_factors(if_src, mask_src)
    pcs = torch.matmul(pif_s, mf_src.transpose(1, 2)) + NEG * poff_s[..., None]
    pc_mesh = torch.softmax(tau_mesh * pcs, dim=1)
    pc_mesh = pc_mesh * (dw_src[:, None, :] >= 0.5)
    g_mat = torch.einsum("bpn,bpk->bnk", pc_mesh, grid_half)   # (B, N, 2)
    s_vec = pc_mesh.sum(dim=1)                                # (B, N)

    pif_t, poff_t = pooled_factors(if_tgt, mask_tgt)
    pif_sel = _take(pif_t, idx_tgt)
    poff_sel = torch.gather(poff_t, 1, idx_tgt)
    pct_sel = (torch.matmul(pif_sel, mf_tgt.transpose(1, 2))
               + NEG * poff_sel[..., None])
    pc_img_sel = torch.softmax(tau_img * pct_sel, dim=2)
    pc_img_sel = pc_img_sel * (dw_tgt[:, None, :] >= 0.5)
    num = torch.matmul(pc_img_sel, g_mat)
    den = torch.einsum("bkn,bn->bk", pc_img_sel, s_vec)
    match_sel = num / (den[..., None] + 1e-5)
    loss = (torch.linalg.vector_norm(match_sel - pts_src, dim=-1)
            * mmask).mean()
    return loss, dict(pts_src=pts_src, pts_tgt=pts_tgt, match=match_sel,
                      mask=mmask)
