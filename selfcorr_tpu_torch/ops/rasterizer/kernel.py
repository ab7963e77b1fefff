"""Build, bind and launch the fused-rasterizer CUDA kernels:

  csrc/raster_fwd.cu  replaces the TPU kernel `_fwd_kernel_compact`
                      (selfcorr_tpu/ops/rasterizer/pallas_raster.py:806)
  csrc/raster_bwd.cu  replaces the TPU kernel `_bwd_kernel_compact`
                      (pallas_raster.py:1177, per-group math
                      `_bwd_chunk_grads` :877)

The sources have a plain C interface and include no PyTorch header;
utils/cuda_build.py compiles them with nvcc for sm_90a into
selfcorr_tpu_torch/_build/ at first use, and ctypes binds the C functions. A
failed build raises. Nothing here runs at import time, so the CPU tests can
import the module on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from selfcorr_tpu_torch.ops.rasterizer import common as C
from selfcorr_tpu_torch.ops.rasterizer.reference import (BWD_GRADS,
                                                         BWD_PLANES, PLANES)
from selfcorr_tpu_torch.utils import cuda_build

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"raster_fused_fwd": os.path.join(_HERE, "csrc", "raster_fwd.cu"),
           "raster_fused_bwd": os.path.join(_HERE, "csrc", "raster_bwd.cu")}
CUDA_FLAGS = cuda_build.CUDA_FLAGS

# launches of each kernel, counted by its wrapper where it launches
LAUNCHES = {"raster_fused_fwd": 0, "raster_fused_bwd": 0}

_lib = None  # {kernel name: bound C function}, after build()


def build() -> dict:
    """Compile (once per process, both sources at once) and bind the
    kernels."""
    global _lib
    if _lib is None:
        cuda_build.build_all(list(SOURCES.values()))
        fwd = cuda_build.load(SOURCES["raster_fused_fwd"]).raster_fused_fwd
        fwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                        + [ctypes.c_float] * 13 + [ctypes.c_void_p] * 2)
        fwd.restype = ctypes.c_int
        bwd = cuda_build.load(SOURCES["raster_fused_bwd"]).raster_fused_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                        + [ctypes.c_float] * 12 + [ctypes.c_void_p] * 2)
        bwd.restype = ctypes.c_int
        _lib = {"raster_fused_fwd": fwd, "raster_fused_bwd": bwd}
    return _lib


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cull_pad(sigma1: float, sigma2: float) -> float:
    """Bbox cull radius: a face reaches no pixel farther than
    sqrt(sigma * DIST_CUT) from it (pallas_raster.py:1293), with a margin
    for rounding in the squared distance."""
    return math.sqrt(max(sigma1, sigma2) * C.DIST_CUT) * 1.001 + 1e-6


def _check_consts(consts: torch.Tensor, name: str):
    if not consts.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if consts.dtype != torch.float32 or consts.dim() != 3 \
            or consts.shape[-1] != C.K:
        raise ValueError(f"consts must be (B, F, {C.K}) float32, got "
                         f"{tuple(consts.shape)} {consts.dtype}")


def raster_fused_fwd_cuda(consts: torch.Tensor, image_size: int,
                          sigma1: float, sigma2: float, gamma_d: float,
                          gamma_t: float) -> dict:
    """consts (B, F, 64) float32 on a CUDA device -> the 13 (B, S, S)
    planes of reference.PLANES, computed by the CUDA kernel."""
    _check_consts(consts, "raster_fused_fwd_cuda")
    b, f, _ = consts.shape
    s = int(image_size)
    if b < 1 or s < 1:
        raise ValueError(f"empty render: B={b}, S={s}")
    fn = build()["raster_fused_fwd"]
    consts = consts.contiguous()
    out = torch.empty((len(PLANES), b, s, s), dtype=torch.float32,
                      device=consts.device)
    with torch.cuda.device(consts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(consts.data_ptr(), b, f, s, 1.0 / sigma1, 1.0 / sigma2,
                1.0 / gamma_d, 1.0 / gamma_t, C.NEAR, C.FAR,
                1.0 / (C.FAR - C.NEAR), C.BG_EPS, C.EYE_OFFSET,
                sigma1 * C.DIST_CUT, sigma2 * C.DIST_CUT,
                cull_pad(sigma1, sigma2), 1.0 / s, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"raster_fused_fwd launch failed: CUDA error {rc}")
    LAUNCHES["raster_fused_fwd"] += 1
    return dict(zip(PLANES, out.unbind(0)))


def raster_fused_bwd_cuda(consts: torch.Tensor, planes: dict, grads: dict,
                          image_size: int, sigma1: float, sigma2: float,
                          gamma_d: float, gamma_t: float) -> torch.Tensor:
    """d/d(consts) (B, F, 64) from the forward's planes (reference.
    BWD_PLANES) and the cotangents (reference.BWD_GRADS), each (B, S, S),
    computed by the CUDA kernel. Deterministic: one fixed-order reduction
    per face, no atomics."""
    _check_consts(consts, "raster_fused_bwd_cuda")
    b, f, _ = consts.shape
    s = int(image_size)
    pix = torch.stack([planes[n] for n in BWD_PLANES]
                      + [grads[n] for n in BWD_GRADS]).float()
    if pix.device != consts.device or pix.shape != (16, b, s, s):
        raise ValueError(f"planes and cotangents must be ({b}, {s}, {s}) "
                         f"on {consts.device}, got {tuple(pix.shape[1:])} "
                         f"on {pix.device}")
    fn = build()["raster_fused_bwd"]
    consts = consts.contiguous()
    grad = torch.empty_like(consts)
    with torch.cuda.device(consts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(consts.data_ptr(), pix.data_ptr(), b, f, s, 1.0 / sigma1,
                1.0 / sigma2, 1.0 / gamma_d, 1.0 / gamma_t, C.NEAR, C.FAR,
                1.0 / (C.FAR - C.NEAR), C.EYE_OFFSET, sigma1 * C.DIST_CUT,
                sigma2 * C.DIST_CUT, cull_pad(sigma1, sigma2), 1.0 / s,
                grad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"raster_fused_bwd launch failed: CUDA error {rc}")
    LAUNCHES["raster_fused_bwd"] += 1
    return grad
