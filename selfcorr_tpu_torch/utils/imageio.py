"""Image files in and out, through Pillow: the dataset readers' decoding
(counterpart of the cv2.imread calls of selfcorr_tpu/data/{wild6d,nocs,
cub}.py), the fixtures' writers and the evaluation's panels.

Pillow is the one decoder: it is installed beside PyTorch on the GPU
machine and in the test environment, and, like cv2, it decodes JPEG with
libjpeg-turbo's ISLOW IDCT and fancy upsampling, so a frame decodes bit for
bit as cv2.imread decodes it (tests/test_torch_datasets.py). There is no
second path: without Pillow every reader raises ImportError naming it.

As cv2.imread does, the readers of colour and gray images apply a JPEG's
EXIF orientation; read_unchanged does not (cv2's IMREAD_UNCHANGED).
"""
from __future__ import annotations

import numpy as np


def to_u8(img01: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8, truncating as the JAX package's vis does."""
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def _pil():
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError("the dataset readers decode images with Pillow "
                          "(PIL), which is not installed") from e
    return Image, ImageOps


def _open(path: str, orient: bool):
    Image, ImageOps = _pil()
    im = Image.open(path)
    im.load()
    return ImageOps.exif_transpose(im) if orient else im


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1]: cv2.imread(p)[:, :, ::-1] / 255."""
    im = _open(path, orient=True)
    if im.mode != "RGB":
        im = im.convert("RGB")
    return np.asarray(im).astype(np.float32) / 255.0


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8 of an 8-bit gray PNG (the Wild6D and NOCS masks), as
    cv2.imread(p, cv2.IMREAD_GRAYSCALE) reads it; any other file raises."""
    im = _open(path, orient=False)
    if im.format != "PNG" or im.mode != "L":
        raise ValueError(f"{path}: read_gray takes 8-bit gray PNGs, not "
                         f"{im.format} mode {im.mode}")
    _, ImageOps = _pil()
    return np.asarray(ImageOps.exif_transpose(im)).copy()


def read_unchanged(path: str) -> np.ndarray:
    """As cv2.imread(p, cv2.IMREAD_UNCHANGED): the file's dtype and
    channels, a 16-bit gray PNG as uint16 (H, W), 3 and 4 channels in cv2's
    BGR(A) order."""
    im = _open(path, orient=False)
    if im.mode in ("I;16", "I;16B", "I;16L") or (im.mode == "I"
                                                 and im.format == "PNG"):
        return np.asarray(im).astype(np.uint16)
    if im.mode not in ("L", "RGB", "RGBA"):
        raise ValueError(f"{path}: read_unchanged takes 8-bit gray, RGB or "
                         f"RGBA and 16-bit gray images, not mode {im.mode}")
    a = np.asarray(im)
    if a.ndim == 3:
        a = a[:, :, [2, 1, 0, 3][:a.shape[2]]]
    return np.ascontiguousarray(a)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """(H, W, 3) uint8 RGB to a baseline JPEG (4:2:0), as
    cv2.imwrite(p, bgr, [IMWRITE_JPEG_QUALITY, quality])."""
    Image, _ = _pil()
    Image.fromarray(np.ascontiguousarray(rgb, np.uint8)).save(
        path, "JPEG", quality=int(quality), subsampling="4:2:0")


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 gray, (H, W, 3) uint8 RGB or (H, W) uint16 gray to a
    PNG, the values exact."""
    Image, _ = _pil()
    img = np.ascontiguousarray(img)
    if not ((img.dtype == np.uint16 and img.ndim == 2)
            or (img.dtype == np.uint8 and (img.ndim == 2 or (
                img.ndim == 3 and img.shape[2] == 3)))):
        raise ValueError(f"unsupported PNG array {img.dtype} {img.shape}")
    Image.fromarray(img).save(path, "PNG")
