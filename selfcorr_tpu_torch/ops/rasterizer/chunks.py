"""Tile geometry and the chunk cull of the dense-chunk schedule
(counterpart of compute_chunk_info, selfcorr_tpu/ops/rasterizer/
pallas_raster.py:257-329).

The image is cut into tiles: 16 x 64 pixels when common.lane_split_for(S)
(the JAX package's lane-split geometry), else 8 x min(128, S). The faces,
sorted and padded by common.pack_constants, form chunks of FF = 16
consecutive faces. For each (batch element, tile), compute_chunk_info gives
the span [first, last + 1) of the chunks whose bbox overlaps the tile's box
padded by the cull radius, and a bitmask of exactly those chunks. It runs as
torch operations on the constants' device, outside any kernel, as XLA runs
it outside the Pallas kernel; the dense-chunk kernels and their plain
versions read it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from selfcorr_tpu_torch.ops.rasterizer import common as C


class Tiles(NamedTuple):
    rows: int     # pixel rows per tile
    cols: int     # pixel columns per tile
    n_rows: int   # tile rows
    n_cols: int   # tile columns

    @property
    def count(self) -> int:
        return self.n_rows * self.n_cols


def tiles_for(image_size: int) -> Tiles:
    """The tile geometry at image size S. The JAX kernels take S divisible
    by the tile; here a ragged last row or column of tiles covers the rest
    (its box reaches past the image, so its cull stays conservative)."""
    s = image_size
    if C.lane_split_for(s):
        tr, tc = 2 * C.TR, C.TC // 2
    else:
        tr, tc = C.TR, min(C.TC, s)
    return Tiles(tr, tc, -(-s // tr), -(-s // tc))


def n_words(n_chunks: int) -> int:
    return -(-n_chunks // 32)


def compute_chunk_info(consts: torch.Tensor, image_size: int, pad: float):
    """consts (B, F_pad, K) -> (spans (B, T*2), masks (B, T*W)) int32 for
    the T tiles of tiles_for(image_size), W = ceil(n_chunks / 32) words:
      spans[b, 2t : 2t+2]  = [first, last + 1) of the chunks that overlap
                             tile t (first = last + 1 = n_chunks if none)
      masks[b, t*W + ci // 32] bit ci % 32 set iff chunk ci's bbox overlaps
                             tile t's box padded by `pad`.
    Padding faces (bbox 1e9) never set a bit."""
    s = image_size
    tl = tiles_for(s)
    b, f_pad, _ = consts.shape
    nc = f_pad // C.FF
    dev = consts.device
    bb = consts[..., C.S_BBOX:C.S_BBOX + 4].reshape(b, nc, C.FF, 4)
    big = -C._BIG
    cxmin = bb[..., 0].amin(-1)                                   # (B, NC)
    cxmax = torch.where(bb[..., 0] >= C._BIG, big, bb[..., 1]).amax(-1)
    cymin = bb[..., 2].amin(-1)
    cymax = torch.where(bb[..., 2] >= C._BIG, big, bb[..., 3]).amax(-1)

    k = torch.arange(tl.n_rows, dtype=torch.float32, device=dev)
    y_hi = (s - 1.0 - 2.0 * (k * tl.rows)) / s + pad              # (R,)
    y_lo = (s - 1.0 - 2.0 * (k * tl.rows + tl.rows - 1)) / s - pad
    c = torch.arange(tl.n_cols, dtype=torch.float32, device=dev)
    x_lo = (2.0 * (c * tl.cols) + 1.0 - s) / s - pad              # (C,)
    x_hi = (2.0 * ((c + 1.0) * tl.cols - 1.0) + 1.0 - s) / s + pad

    ov_y = ((cymin[:, None, :] <= y_hi[None, :, None])
            & (cymax[:, None, :] >= y_lo[None, :, None]))         # (B, R, NC)
    ov_x = ((cxmin[:, None, :] <= x_hi[None, :, None])
            & (cxmax[:, None, :] >= x_lo[None, :, None]))         # (B, C, NC)
    ov = ov_y[:, :, None, :] & ov_x[:, None, :, :]                # (B,R,C,NC)

    ids = torch.arange(nc, dtype=torch.int32, device=dev)
    start = torch.where(ov, ids, nc).amin(-1) if nc else \
        torch.zeros(ov.shape[:-1], dtype=torch.int32, device=dev)
    end = torch.where(ov, ids + 1, 0).amax(-1) if nc else start
    spans = torch.stack([start, torch.maximum(end, start)], -1).to(
        torch.int32)

    w = n_words(nc)
    ov = torch.nn.functional.pad(ov, (0, w * 32 - nc))
    bits = ov.reshape(*ov.shape[:-1], w, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    words = (bits * weights).sum(-1)                  # the uint32 word, >= 0
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    masks = words.to(torch.int32)                     # its int32 bit pattern
    return (spans.reshape(b, tl.count * 2).contiguous(),
            masks.reshape(b, tl.count * w).contiguous())


def pixel_tiles(image_size: int, device=None) -> torch.Tensor:
    """(S*S,) long: the tile of each pixel, row-major (common.pixel_grid's
    order)."""
    s = image_size
    tl = tiles_for(s)
    r = torch.arange(s, device=device)
    rows = (r // tl.rows).repeat_interleave(s)
    cols = (r // tl.cols).repeat(s)
    return rows * tl.n_cols + cols


def visited_chunks(spans: torch.Tensor, masks: torch.Tensor,
                   image_size: int, n_chunks: int) -> torch.Tensor:
    """(B, S*S, n_chunks) bool: whether the dense-chunk schedule visits
    chunk ci at each pixel, i.e. ci lies in the pixel's tile's span and its
    bit is set."""
    b = spans.shape[0]
    dev = spans.device
    n_tiles = tiles_for(image_size).count
    w = n_words(n_chunks)
    ci = torch.arange(n_chunks, device=dev)
    words = masks.reshape(b, n_tiles, w).long()[..., ci // 32]    # (B, T, NC)
    bit = ((words >> (ci % 32)) & 1).bool()
    sp = spans.reshape(b, n_tiles, 2).long()
    in_span = (ci >= sp[..., :1]) & (ci < sp[..., 1:])
    per_tile = bit & in_span
    return per_tile[:, pixel_tiles(image_size, dev)]
