"""Image resampling and color jitter on NHWC tensors (counterpart of
selfcorr_tpu/ops/image_ops.py).

  resize_nearest   torch nearest convention: source index floor(i * in/out)
  resize_bilinear  half-pixel bilinear, no antialias (F.interpolate
                   align_corners=False)
  downsample_area  average pooling by an integer factor
  upsample_repeat  pixel duplication by an integer factor
  rotate_fast      quarter turn + Paeth's three shears as banded products
  grid_sample      F.grid_sample semantics, align_corners=False, zero pad
  color_jitter     brightness -> contrast -> saturation -> hue, one factor
                   draw per call for the whole batch
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from selfcorr_tpu_torch.utils.device import upload


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) with source rows floor(i * H/h)."""
    h_in, w_in = img.shape[-3], img.shape[-2]
    h, w = out_hw
    dev = img.device
    ri = torch.floor(torch.arange(h, dtype=torch.float32, device=dev)
                     * (h_in / h)).long()
    ci = torch.floor(torch.arange(w, dtype=torch.float32, device=dev)
                     * (w_in / w)).long()
    return img[..., ri[:, None], ci[None, :], :]


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Half-pixel-centre bilinear resize of (B, H, W, C)."""
    x = img.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)


def downsample_area(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool (..., H, W, C) by an integer factor (torch 'area'
    downsampling)."""
    if factor == 1:
        return img
    *lead, h, w, c = img.shape
    x = img.reshape(*lead, h // factor, factor, w // factor, factor, c)
    return x.mean(dim=(-4, -2))


def upsample_repeat(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Duplicate each pixel of (..., H, W, C) factor x factor times (torch
    'area' upsampling by an integer factor)."""
    if factor == 1:
        return img
    x = torch.repeat_interleave(img, factor, dim=-3)
    return torch.repeat_interleave(x, factor, dim=-2)


def _shear_matrix(n: int, shifts: torch.Tensor, mode: str) -> torch.Tensor:
    """(R, N_in, N_out) 1-D resampling operators: out[., j] = sum_i
    T[r, i, j] in[., i], sampling source index j + shifts[r] with a tent
    kernel (bilinear) or one-hot (nearest), zero outside."""
    dev = shifts.device
    i = torch.arange(n, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(n, dtype=torch.float32, device=dev)[None, None, :]
    src = j + shifts[:, None, None]
    if mode == "nearest":
        return (torch.round(src) == i).to(torch.float32)
    return torch.clamp(1.0 - torch.abs(i - src), min=0.0)


def rotate_fast(img: torch.Tensor, angle_deg, mode: str = "bilinear"
                ) -> torch.Tensor:
    """Rotate square (B, H, W, C) images counter-clockwise by angle_deg
    about the centre, zero fill, as the JAX package's rotate_fast
    (selfcorr_tpu/ops/image_ops.py:174-225): an exact quarter turn, then
    Paeth's three shears as banded one-hot products (torch.einsum). The
    three-pass filter differs slightly from direct bilinear sampling, so
    torchvision's rotate is no substitute. angle_deg is a float or a
    0-d tensor (the injectable draw)."""
    b, h, w, c = img.shape
    if h != w:
        raise ValueError("rotate_fast needs square images")
    # the angle's arithmetic runs in float32 on the host, and the shear
    # factors reach the device as numbers: no copy waits for the device
    theta = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32)
                          .cpu())
    turns = torch.floor((theta + torch.pi / 4) / (torch.pi / 2))
    k = int(turns) % 4
    phi = theta - (torch.pi / 2) * turns
    if k == 1:      # out[r, c] = in[c, h-1-r]
        img = torch.flip(img.transpose(1, 2), dims=(1,))
    elif k == 2:
        img = torch.flip(img, dims=(1, 2))
    elif k == 3:    # out[r, c] = in[h-1-c, r]
        img = torch.flip(img.transpose(1, 2), dims=(2,))
    a = float(-torch.tan(phi / 2.0))
    bb = float(torch.sin(phi))
    rows = torch.arange(h, dtype=torch.float32, device=img.device) \
        - (h - 1) / 2.0
    tx = _shear_matrix(w, a * rows, mode)    # x-shear per row
    ty = _shear_matrix(h, bb * rows, mode)   # y-shear per column
    x = torch.einsum("brid,rij->brjd", img, tx)
    x = torch.einsum("bicd,cij->bjcd", x, ty)
    return torch.einsum("brid,rij->brjd", x, tx)


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample (B, H, W, C) at NDC coords (B, N, 2) -> (B, N, C).
    ix = (x + 1) * W/2 - 0.5; taps outside the image read zero."""
    b, h, w, c = img.shape
    x = (coords[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (coords[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(b, h * w, c)

    def gather(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v * inb[..., None]

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


_RGB2YIQ_NP = np.array([[0.2989, 0.587, 0.114],
                        [0.595716, -0.274453, -0.321263],
                        [0.211456, -0.522591, 0.311135]], np.float32)
_YIQ2RGB_NP = np.linalg.inv(_RGB2YIQ_NP.astype(np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _yiq_matrices(device: torch.device) -> tuple:
    """RGB -> YIQ and YIQ -> RGB on `device`, made there once."""
    return (torch.as_tensor(_RGB2YIQ_NP, device=device),
            torch.as_tensor(_YIQ2RGB_NP, device=device))


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    return (0.2989 * img[..., 0:1] + 0.587 * img[..., 1:2]
            + 0.114 * img[..., 2:3])


def jitter_factors(generator: torch.Generator, brightness: float = 0.2,
                   contrast: float = 0.2, saturation: float = 0.2,
                   hue: float = 0.05) -> torch.Tensor:
    """(4,) float32 [fb, fc, fs, fh] drawn on the CPU from `generator`:
    fb, fc, fs ~ U(1 - r, 1 + r), fh ~ U(-hue, hue)."""
    u = torch.rand(4, generator=generator, dtype=torch.float32)
    lo = torch.tensor([1 - brightness, 1 - contrast, 1 - saturation, -hue])
    hi = torch.tensor([1 + brightness, 1 + contrast, 1 + saturation, hue])
    return lo + u * (hi - lo)


def color_jitter(img: torch.Tensor, factors: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Batch-wide color jitter of (B, H, W, 3) in [0, 1].

    factors (4,) = [brightness, contrast, saturation, hue] — the draws, so
    tests can inject the JAX package's; when absent they come from
    `generator` (jitter_factors). Order: brightness -> contrast (toward the
    per-image gray mean) -> saturation -> hue (chroma rotation in YIQ)."""
    if factors is None:
        if generator is None:
            raise ValueError("color_jitter needs factors or a generator")
        factors = jitter_factors(generator)
    f = torch.as_tensor(factors, dtype=img.dtype)
    if f.device != img.device:
        f = upload([f], img.device)[0]
    fb, fc, fs, fh = f[0], f[1], f[2], f[3]
    x = img * fb
    gray_mean = _rgb_to_gray(x).mean(dim=(-3, -2), keepdim=True)
    x = fc * x + (1 - fc) * gray_mean
    x = fs * x + (1 - fs) * _rgb_to_gray(x)
    rgb2yiq, yiq2rgb = _yiq_matrices(img.device)
    yiq = torch.einsum("...c,dc->...d", x, rgb2yiq)
    th = 2 * np.pi * fh
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    i2 = cos_t * yiq[..., 1:2] - sin_t * yiq[..., 2:3]
    q2 = sin_t * yiq[..., 1:2] + cos_t * yiq[..., 2:3]
    yiq = torch.cat([yiq[..., 0:1], i2, q2], dim=-1)
    x = torch.einsum("...c,dc->...d", yiq, yiq2rgb)
    return torch.clamp(x, 0.0, 1.0)
