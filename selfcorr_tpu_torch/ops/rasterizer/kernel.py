"""Build, bind and launch the fused-rasterizer CUDA kernels:

  csrc/raster_fwd.cu        B1, replaces the TPU kernel `_fwd_kernel_compact`
                            (selfcorr_tpu/ops/rasterizer/pallas_raster.py:806)
  csrc/raster_bwd.cu        B2, replaces `_bwd_kernel_compact` (:1177,
                            per-group math `_bwd_chunk_grads` :877)
  csrc/raster_fwd_chunk.cu  B1', replaces `_fwd_kernel` (:730), the
                            dense-chunk schedule
  csrc/raster_bwd_chunk.cu  B2', replaces `_bwd_kernel` (:1117)

The four share their per-pair device code through csrc/raster_common.cuh.
The sources have a plain C interface and include no PyTorch header;
utils/cuda_build.py compiles them with nvcc for sm_90a into
selfcorr_tpu_torch/_build/ at first use, one nvcc per source, all at once,
and ctypes binds the C functions. A failed build raises, and so does a
launch the card refuses. fwd_visits is the CPU mirror of the forwards'
culls: it counts the (face, pixel) pairs on which B1 and B1' shade;
bwd_visits the mirror of the backwards' walk: the pixels on which B2 and B2'
run the cover test.
Nothing here runs at import time, so the CPU tests can import the module on
machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from selfcorr_tpu_torch.ops.rasterizer import common as C
from selfcorr_tpu_torch.ops.rasterizer.chunks import (n_words, tiles_for,
                                                      visited_chunks)
from selfcorr_tpu_torch.ops.rasterizer.reference import (BWD_GRADS,
                                                         BWD_PLANES, PLANES)
from selfcorr_tpu_torch.utils import cuda_build

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {name: os.path.join(_HERE, "csrc", f"{src}.cu") for name, src in (
    ("raster_fused_fwd", "raster_fwd"), ("raster_fused_bwd", "raster_bwd"),
    ("raster_fused_fwd_chunk", "raster_fwd_chunk"),
    ("raster_fused_bwd_chunk", "raster_bwd_chunk"))}
CUDA_FLAGS = cuda_build.CUDA_FLAGS

# launches of each kernel, counted by its wrapper where it launches
LAUNCHES = dict.fromkeys(SOURCES, 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: the inputs, the ints, then the 13 floats of Params
# (raster_common.cuh), then the output and the stream
_ARGTYPES = {
    "raster_fused_fwd": [_P] + [_I] * 5,
    "raster_fused_bwd": [_P, _P] + [_I] * 5,
    "raster_fused_fwd_chunk": [_P] * 3 + [_I] * 10,
    "raster_fused_bwd_chunk": [_P] * 4 + [_I] * 10,
}

_lib = None  # {kernel name: bound C function}, after build()

# The forwards' tiles (csrc/raster_common.cuh, raster_fwd.cu,
# raster_fwd_chunk.cu): a warp shades a sub-tile of SUB_COLS columns x
# LANE_ROWS rows, a pixel a lane, and skips each face whose bbox, padded by
# the cull radius, misses the sub-tile's box; B1 first culls per block of
# FWD_BLOCK_ROWS x FWD_BLOCK_COLS pixels.
SUB_COLS, LANE_ROWS = 8, 4
FWD_BLOCK_ROWS, FWD_BLOCK_COLS = 8, 16
# the earlier B1's block cull (16 x 16 blocks), for the visited-pair count
OLD_FWD_TILE = 16


def build() -> dict:
    """Compile (once per process, all sources at once) and bind the
    kernels."""
    global _lib
    if _lib is None:
        cuda_build.build_all(list(SOURCES.values()))
        lib = {}
        for name, src in SOURCES.items():
            fn = getattr(cuda_build.load(src), name)
            fn.argtypes = _ARGTYPES[name] + [_F] * 13 + [_P, _P]
            fn.restype = ctypes.c_int
            lib[name] = fn
        _lib = lib
    return _lib


def _box_hits(consts, s, pad, rows, cols):
    """(B, ceil(s / rows), ceil(s / cols), F) bool: whether each face's
    bbox, padded by pad, meets each rows x cols pixel box (clipped to the
    image), in the kernels' float32 arithmetic (raster_common.cuh
    sub_tile, raster_fwd.cu's block box): a pixel's centre is
    (2 c + 1 - S) / S, (S - 1 - 2 r) / S through the float32 reciprocal."""
    f32 = torch.float32
    inv_s = torch.tensor(1.0 / s, dtype=f32)
    pad = torch.tensor(pad, dtype=f32)
    c0 = torch.arange(0, s, cols, dtype=f32)
    r0 = torch.arange(0, s, rows, dtype=f32)
    c_hi = torch.clamp(c0 + cols, max=s) - 1.0
    r_hi = torch.clamp(r0 + rows, max=s) - 1.0
    x_lo = (2.0 * c0 + 1.0 - s) * inv_s - pad
    x_hi = (2.0 * c_hi + 1.0 - s) * inv_s + pad
    y_hi = ((s - 1.0) - 2.0 * r0) * inv_s + pad
    y_lo = ((s - 1.0) - 2.0 * r_hi) * inv_s - pad
    bb = consts[..., C.S_BBOX:C.S_BBOX + 4].float().cpu()
    hit_x = ((bb[:, None, :, 0] <= x_hi[None, :, None])
             & (bb[:, None, :, 1] >= x_lo[None, :, None]))   # (B, nc, F)
    hit_y = ((bb[:, None, :, 2] <= y_hi[None, :, None])
             & (bb[:, None, :, 3] >= y_lo[None, :, None]))   # (B, nr, F)
    return hit_y[:, :, None, :] & hit_x[:, None, :, :]


def _box_pixels(s, rows, cols):
    """(ceil(s / rows), ceil(s / cols)) long: the image's pixels in each
    rows x cols box."""
    nr = torch.clamp(s - torch.arange(0, s, rows), max=rows)
    nc = torch.clamp(s - torch.arange(0, s, cols), max=cols)
    return nr[:, None] * nc[None, :]


def fwd_visits(consts: torch.Tensor, image_size: int, sigma1: float,
               sigma2: float, chunks=None) -> torch.Tensor:
    """The CPU mirror of B1's (chunks=None) or B1''s (chunks = (spans,
    masks)) cull: (B, ceil(S / LANE_ROWS), ceil(S / SUB_COLS), F) bool,
    whether the warp of each sub-tile shades face f at its pixels. B1: the
    face passes its block's test and its sub-tile's; B1': its chunk lies in
    its tile's span with its bit set, and it passes its sub-tile's test."""
    b, f, _ = consts.shape
    s = int(image_size)
    pad = cull_pad(sigma1, sigma2)
    hits = _box_hits(consts, s, pad, LANE_ROWS, SUB_COLS)
    if chunks is None:
        block = _box_hits(consts, s, pad, FWD_BLOCK_ROWS, FWD_BLOCK_COLS)
        up = torch.arange(hits.shape[1]) // (FWD_BLOCK_ROWS // LANE_ROWS)
        across = torch.arange(hits.shape[2]) // (FWD_BLOCK_COLS // SUB_COLS)
        return hits & block[:, up][:, :, across]
    tl = tiles_for(s)
    visit = visited_chunks(*(t.cpu() for t in chunks), s, f // C.FF)
    # (B, S * S, n_chunks) per pixel -> per tile -> per sub-tile
    per_tile = visit.reshape(b, s, s, -1)[:, ::tl.rows, ::tl.cols]
    up = torch.arange(hits.shape[1]) * LANE_ROWS // tl.rows
    across = torch.arange(hits.shape[2]) * SUB_COLS // tl.cols
    face = per_tile[:, up][:, :, across][..., torch.arange(f) // C.FF]
    return hits & face


def visited_pairs(consts: torch.Tensor, image_size: int, sigma1: float,
                  sigma2: float, chunks=None) -> int:
    """The (face, pixel) pairs on which B1 (or, with chunks, B1') runs
    `shade`: fwd_visits times the pixels of each sub-tile."""
    visits = fwd_visits(consts, image_size, sigma1, sigma2, chunks)
    pix = _box_pixels(int(image_size), LANE_ROWS, SUB_COLS)
    return int((visits.sum(-1) * pix).sum())


def block_cull_pairs(consts: torch.Tensor, image_size: int, sigma1: float,
                     sigma2: float, tile: int = OLD_FWD_TILE) -> int:
    """The pairs the earlier B1 shaded: every pixel of a tile x tile block
    against each face whose padded bbox meets the block."""
    s = int(image_size)
    hits = _box_hits(consts, s, cull_pad(sigma1, sigma2), tile, tile)
    return int((hits.sum(-1) * _box_pixels(s, tile, tile)).sum())


def _face_boxes(consts, s, pad):
    """Each face's padded pixel box as raster_common.cuh face_box computes
    it in float32: (c_lo, c_hi, r_lo, r_hi), each (B, F) long, empty
    (c_hi < c_lo) for a face off screen, with NaN bounds, or padding."""
    f32, dev = torch.float32, consts.device
    bb = consts[..., C.S_BBOX:C.S_BBOX + 4].float()
    pad = torch.tensor(pad, dtype=f32, device=dev)
    fs = torch.tensor(float(s), dtype=f32, device=dev)
    xlo, xhi = bb[..., 0] - pad, bb[..., 1] + pad
    ylo, yhi = bb[..., 2] - pad, bb[..., 3] + pad
    ok = (xlo <= 2.0) & (xhi >= -2.0) & (ylo <= 2.0) & (yhi >= -2.0)
    cl = torch.clamp((xlo * fs + fs - 1.0) * 0.5, min=0.0)
    ch = torch.clamp((xhi * fs + fs - 1.0) * 0.5, max=s - 1.0)
    rl = torch.clamp((fs - 1.0 - yhi * fs) * 0.5, min=0.0)
    rh = torch.clamp((fs - 1.0 - ylo * fs) * 0.5, max=s - 1.0)

    def lo(v):
        return torch.where(ok, (torch.floor(v).long() - 1).clamp(min=0), 0)

    def hi(v):
        return torch.where(ok, (torch.ceil(v).long() + 1).clamp(max=s - 1),
                           -1)
    return lo(cl), hi(ch), lo(rl), hi(rh)


def bwd_visits(consts: torch.Tensor, image_size: int, sigma1: float,
               sigma2: float, chunks=None) -> torch.Tensor:
    """The CPU mirror of B2's (chunks=None) or B2''s (chunks = (spans,
    masks)) walk: (B, S * S, F) bool, row-major pixels, whether the kernel
    runs the cover test on each (pixel, face) pair. B2: the pixel lies in
    the face's padded box; B2': also, the cull visits the face's chunk at
    the pixel's tile. Computed on the constants' device."""
    b, f, _ = consts.shape
    s = int(image_size)
    c_lo, c_hi, r_lo, r_hi = _face_boxes(consts, s, cull_pad(sigma1, sigma2))
    i = torch.arange(s, device=consts.device)[None, :, None]
    rows = (i >= r_lo[:, None]) & (i <= r_hi[:, None])          # (B, S, F)
    cols = (i >= c_lo[:, None]) & (i <= c_hi[:, None])
    visits = (rows[:, :, None] & cols[:, None]).reshape(b, s * s, f)
    if chunks is not None:
        visit = visited_chunks(*chunks, s, f // C.FF)        # (B, S*S, NC)
        visits &= visit[..., torch.arange(f, device=visit.device) // C.FF]
    return visits


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cull_pad(sigma1: float, sigma2: float) -> float:
    """Bbox cull radius: a face reaches no pixel farther than
    sqrt(sigma * DIST_CUT) from it (pallas_raster.py:1293), with a margin
    for rounding in the squared distance."""
    return math.sqrt(max(sigma1, sigma2) * C.DIST_CUT) * 1.001 + 1e-6


def _params(image_size, sigma1, sigma2, gamma_d, gamma_t):
    """The 13 floats of Params (csrc/raster_common.cuh): every division by
    a constant is a multiplication by its float32 reciprocal."""
    return (1.0 / sigma1, 1.0 / sigma2, 1.0 / gamma_d, 1.0 / gamma_t,
            C.NEAR, C.FAR, 1.0 / (C.FAR - C.NEAR), C.BG_EPS, C.EYE_OFFSET,
            sigma1 * C.DIST_CUT, sigma2 * C.DIST_CUT,
            cull_pad(sigma1, sigma2), 1.0 / image_size)


def _check_consts(consts: torch.Tensor, name: str, tex_res: int):
    if not consts.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    k = consts.shape[-1] if consts.dim() == 3 else -1
    if consts.dtype != torch.float32 or k < C.K or k % 64:
        raise ValueError(f"consts must be (B, F, 64 n) float32, got "
                         f"{tuple(consts.shape)} {consts.dtype}")
    if k != C.k_for(tex_res):
        raise ValueError(f"tex_res={tex_res} needs {C.k_for(tex_res)} "
                         f"packed slots per face, got {k}")


def _check_chunks(consts, spans, masks, s):
    b, f, _ = consts.shape
    if f % C.FF:
        raise ValueError(f"the dense-chunk kernels need F a multiple of "
                         f"{C.FF} (common.pack_constants pads it), got {f}")
    n_t = tiles_for(s).count
    want = ((b, n_t * 2), (b, n_t * n_words(f // C.FF)))
    for t, shape, what in ((spans, want[0], "spans"),
                           (masks, want[1], "masks")):
        if t.device != consts.device or t.dtype != torch.int32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"{what} must be int32 {shape} on "
                             f"{consts.device} (chunks.compute_chunk_info), "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _pix(consts, planes, grads, s):
    """The 16 (B, S, S) planes of the backward, image-major (B, 16, S, S)
    as B2 and B2' read them: BWD_PLANES, then the cotangents of
    BWD_GRADS."""
    b = consts.shape[0]
    pix = torch.stack([planes[n] for n in BWD_PLANES]
                      + [grads[n] for n in BWD_GRADS],
                      dim=1).float().contiguous()
    if pix.device != consts.device or pix.shape != (b, 16, s, s):
        raise ValueError(f"planes and cotangents must be ({b}, {s}, {s}) "
                         f"on {consts.device}, got 16 stacked as "
                         f"{tuple(pix.shape)} on {pix.device}")
    return pix


def _launch(name, consts, *args):
    """Launch `name` on the current stream of consts' device; raise on the
    launch's CUDA error; count it."""
    fn = build()[name]
    with torch.cuda.device(consts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def raster_fused_fwd_cuda(consts: torch.Tensor, image_size: int,
                          sigma1: float, sigma2: float, gamma_d: float,
                          gamma_t: float, tex_res: int = 0) -> dict:
    """consts (B, F, K) float32 on a CUDA device -> the 13 (B, S, S)
    planes of reference.PLANES, computed by B1."""
    _check_consts(consts, "raster_fused_fwd_cuda", tex_res)
    b, f, k = consts.shape
    s = int(image_size)
    if b < 1 or s < 1:
        raise ValueError(f"empty render: B={b}, S={s}")
    consts = consts.contiguous()
    out = torch.empty((len(PLANES), b, s, s), dtype=torch.float32,
                      device=consts.device)
    _launch("raster_fused_fwd", consts, consts.data_ptr(), b, f, s, k,
            tex_res, *_params(s, sigma1, sigma2, gamma_d, gamma_t),
            out.data_ptr())
    return dict(zip(PLANES, out.unbind(0)))


def raster_fused_bwd_cuda(consts: torch.Tensor, planes: dict, grads: dict,
                          image_size: int, sigma1: float, sigma2: float,
                          gamma_d: float, gamma_t: float,
                          tex_res: int = 0) -> torch.Tensor:
    """d/d(consts) (B, F, K) from the forward's planes (reference.
    BWD_PLANES) and the cotangents (reference.BWD_GRADS), each (B, S, S),
    computed by B2. Deterministic: one fixed-order reduction per face, no
    atomics."""
    _check_consts(consts, "raster_fused_bwd_cuda", tex_res)
    b, f, k = consts.shape
    s = int(image_size)
    pix = _pix(consts, planes, grads, s)
    consts = consts.contiguous()
    grad = torch.empty_like(consts)
    _launch("raster_fused_bwd", consts, consts.data_ptr(), pix.data_ptr(),
            b, f, s, k, tex_res,
            *_params(s, sigma1, sigma2, gamma_d, gamma_t), grad.data_ptr())
    return grad


def _tile_args(consts, s):
    b, f, _ = consts.shape
    tl = tiles_for(s)
    return (tl.rows, tl.cols, tl.n_rows, tl.n_cols, n_words(f // C.FF))


def raster_fused_fwd_chunk_cuda(consts: torch.Tensor, spans: torch.Tensor,
                                masks: torch.Tensor, image_size: int,
                                sigma1: float, sigma2: float,
                                gamma_d: float, gamma_t: float,
                                tex_res: int = 0) -> dict:
    """The 13 planes of the dense-chunk schedule, computed by B1': consts
    (B, F, K) with F a multiple of 16, and spans, masks from
    chunks.compute_chunk_info, all on one CUDA device."""
    _check_consts(consts, "raster_fused_fwd_chunk_cuda", tex_res)
    b, f, k = consts.shape
    s = int(image_size)
    if b < 1 or s < 1:
        raise ValueError(f"empty render: B={b}, S={s}")
    _check_chunks(consts, spans, masks, s)
    consts, spans, masks = (t.contiguous() for t in (consts, spans, masks))
    out = torch.empty((len(PLANES), b, s, s), dtype=torch.float32,
                      device=consts.device)
    _launch("raster_fused_fwd_chunk", consts, consts.data_ptr(),
            spans.data_ptr(), masks.data_ptr(), b, f, s, k, tex_res,
            *_tile_args(consts, s),
            *_params(s, sigma1, sigma2, gamma_d, gamma_t), out.data_ptr())
    return dict(zip(PLANES, out.unbind(0)))


def raster_fused_bwd_chunk_cuda(consts: torch.Tensor, spans: torch.Tensor,
                                masks: torch.Tensor, planes: dict,
                                grads: dict, image_size: int, sigma1: float,
                                sigma2: float, gamma_d: float,
                                gamma_t: float,
                                tex_res: int = 0) -> torch.Tensor:
    """d/d(consts) of the dense-chunk schedule, computed by B2': B2's
    kernel, which tests only the pixels of tiles whose cull visits the
    face's chunk. Deterministic: one warp per face, a fixed-order
    reduction, no atomics."""
    _check_consts(consts, "raster_fused_bwd_chunk_cuda", tex_res)
    b, f, k = consts.shape
    s = int(image_size)
    _check_chunks(consts, spans, masks, s)
    pix = _pix(consts, planes, grads, s)
    consts, spans, masks = (t.contiguous() for t in (consts, spans, masks))
    grad = torch.empty_like(consts)
    _launch("raster_fused_bwd_chunk", consts, consts.data_ptr(),
            spans.data_ptr(), masks.data_ptr(), pix.data_ptr(), b, f, s, k,
            tex_res, *_tile_args(consts, s),
            *_params(s, sigma1, sigma2, gamma_d, gamma_t), grad.data_ptr())
    return grad
