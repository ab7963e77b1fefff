"""Correspondence losses and the batch-pairing index transforms (counterpart
of selfcorr_tpu/losses/match_losses.py).

A training batch is laid out video-major, frame-minor ([v1f1..v1fR,
v2f1..v2fR, ...]); src/tgt pairs roll frames within a video ('frame'),
videos within the batch ('instance'), or both, concatenated ('both')."""
from __future__ import annotations

import torch


def match_loss(match, match_gt, match_mask, mask):
    """||match - match_gt|| over pixels where the render and the object mask
    are both on. match (B, H, W, 3); masks (B, H, W). Returns (B,)."""
    m = ((match_mask > 0) & (mask > 0)).to(match.dtype)
    err = torch.linalg.vector_norm(match - match_gt, dim=-1) * m
    return err.mean(dim=(1, 2))


def imatch_loss(imatch, imatch_gt, depth_weight):
    """Visibility-weighted reprojection error of the per-vertex matches.
    imatch (B, N, 2); depth_weight (B, N). Returns (B,)."""
    err = torch.linalg.vector_norm(imatch - imatch_gt, dim=-1) * depth_weight
    return err.mean(dim=1)


def divide_by_frame(x, batch_size: int, repeat: int):
    """src = x; tgt = the next frame of the same video (cyclic)."""
    s = x.reshape(batch_size, repeat, *x.shape[1:])
    t = torch.roll(s, -1, dims=1)
    return s.reshape(x.shape), t.reshape(x.shape)


def divide_by_instance(x, batch_size: int, repeat: int):
    """src = x; tgt = the same frame index of the next video (cyclic)."""
    s = x.reshape(batch_size, repeat, *x.shape[1:])
    t = torch.roll(s, -1, dims=0)
    return s.reshape(x.shape), t.reshape(x.shape)


def divide_by_both(x, batch_size: int, repeat: int):
    sf, tf = divide_by_frame(x, batch_size, repeat)
    si, ti = divide_by_instance(x, batch_size, repeat)
    return torch.cat([sf, si], 0), torch.cat([tf, ti], 0)


DIVIDE_FNS = {"frame": divide_by_frame, "instance": divide_by_instance,
              "both": divide_by_both}
