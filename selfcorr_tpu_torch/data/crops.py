"""Mask-driven crops + crop-space intrinsics, host numpy without cv2
(counterpart of selfcorr_tpu/data/crops.py).

The resizes reproduce cv2.resize on float32 images: INTER_LINEAR is
half-pixel bilinear with clamped (replicated) borders, separable rows then
columns; INTER_NEAREST takes source index floor(i * (1 / (out / in))) in
double precision, as OpenCV computes it.

  foc_crop = foc * (S/2) / length,
  pp_crop  = (pp - (center - length)) * (S/2) / length.
"""
from __future__ import annotations

import numpy as np


def mask_bbox(mask: np.ndarray):
    """(H, W) bool -> center (2,), half-length (2,) in (x, y) order."""
    ys, xs = np.where(mask > 0)
    cx = (xs.max() + xs.min()) // 2
    cy = (ys.max() + ys.min()) // 2
    lx = (xs.max() - xs.min()) // 2
    ly = (ys.max() - ys.min()) // 2
    return np.array([cx, cy], np.int64), np.array([lx, ly], np.int64)


def scaled_lengths(length, scale, no_stretch: bool):
    if no_stretch:
        m = int(scale[0] * max(length[0], length[1]))
        return np.array([m, m], np.int64)
    return np.array([int(scale[0] * length[0]), int(scale[1] * length[1])],
                    np.int64)


def linear_taps(n_in: int, n_out: int):
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    f = np.maximum(f, 0.0)
    i0 = np.minimum(np.floor(f).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (f - i0).astype(np.float32)


def resize(img: np.ndarray, out_size: int, interp: str) -> np.ndarray:
    """(H, W[, C]) -> (out_size, out_size[, C]), cv2.resize semantics."""
    h, w = img.shape[:2]
    if interp == "nearest":
        sx = np.minimum(np.floor(np.arange(out_size) * (1.0 / (out_size / w)))
                        .astype(np.int64), w - 1)
        sy = np.minimum(np.floor(np.arange(out_size) * (1.0 / (out_size / h)))
                        .astype(np.int64), h - 1)
        return img[sy][:, sx]
    x0, x1, fx = linear_taps(w, out_size)
    y0, y1, fy = linear_taps(h, out_size)
    extra = (None,) * (img.ndim - 2)
    fx = fx[(None, slice(None)) + extra]
    fy = fy[(slice(None), None) + extra]
    rows = img[:, x0] * (1 - fx) + img[:, x1] * fx
    return (rows[y0] * (1 - fy) + rows[y1] * fy).astype(img.dtype)


def crop_resize(img: np.ndarray, center, length, out_size: int,
                interp: str) -> np.ndarray:
    """Crop [center - length, center + length), zero-padded at borders, and
    resize to (out_size, out_size). img: (H, W[, C])."""
    h, w = img.shape[:2]
    x0, y0 = int(center[0] - length[0]), int(center[1] - length[1])
    x1, y1 = int(center[0] + length[0]), int(center[1] + length[1])
    cw, ch = x1 - x0, y1 - y0
    if cw <= 0 or ch <= 0:
        return np.zeros((out_size, out_size) + img.shape[2:], img.dtype)
    patch = np.zeros((ch, cw) + img.shape[2:], img.dtype)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x1, w), min(y1, h)
    patch[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return resize(patch, out_size, interp)


def crop_intrinsics(foc, pp, center, length, out_size: int):
    cf = np.array([out_size / 2.0 / length[0], out_size / 2.0 / length[1]])
    foc_crop = np.asarray(foc, np.float64) * cf
    pp_crop = (np.asarray(pp, np.float64)
               - (np.asarray(center) - np.asarray(length))) * cf
    return foc_crop.astype(np.float32), pp_crop.astype(np.float32)


def to_ndc_intrinsics(foc_crop, pp_crop, out_size: int):
    """Pixel-unit crop intrinsics -> NDC units."""
    pp_ndc = pp_crop / (out_size / 2.0) - 1.0
    foc_ndc = foc_crop / (out_size / 2.0)
    return foc_ndc.astype(np.float32), pp_ndc.astype(np.float32)


def crop_frame(img, mask, depth, foc, pp, out_size: int, scale,
               no_stretch: bool = False):
    """Full per-frame crop; returns a dict of numpy arrays.

    img (H, W, 3) float in [0, 1]; mask (H, W) bool; depth (H, W) or None;
    scale (2,) crop scale factors (test: 1.35)."""
    center, length0 = mask_bbox(mask)
    length = np.maximum(scaled_lengths(length0, scale, no_stretch), 1)
    img_c = crop_resize(img.astype(np.float32), center, length, out_size,
                        "bilinear")
    mask_c = crop_resize(mask.astype(np.float32), center, length, out_size,
                         "nearest")
    depth_c = (crop_resize(depth.astype(np.float32), center, length,
                           out_size, "nearest") if depth is not None
               else np.zeros((out_size, out_size), np.float32))
    foc_crop, pp_crop = crop_intrinsics(foc, pp, center, length, out_size)
    foc_ndc, pp_ndc = to_ndc_intrinsics(foc_crop, pp_crop, out_size)
    return dict(img=img_c, mask=mask_c, depth=depth_c,
                center=center.astype(np.float32),
                length=length.astype(np.float32),
                foc=np.asarray(foc, np.float32),
                pp=np.asarray(pp, np.float32),
                foc_crop=foc_ndc, pp_crop=pp_ndc)
