"""Build, bind and launch the fused-rasterizer forward CUDA kernel
(csrc/raster_fwd.cu), which replaces the TPU kernel `_fwd_kernel_compact`
(selfcorr_tpu/ops/rasterizer/pallas_raster.py:806).

The source has a plain C interface and includes no PyTorch header, so
`torch.utils.cpp_extension.load` compiles it in seconds for sm_90a into
selfcorr_tpu_torch/_build/ at first use; ctypes binds the C function. A
failed build raises. Nothing here runs at import time, so the CPU tests can
import the module on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from selfcorr_tpu_torch.ops.rasterizer import common as C
from selfcorr_tpu_torch.ops.rasterizer.reference import PLANES

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "raster_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false"]

# launches of each kernel, counted by its wrapper where it launches
LAUNCHES = {"raster_fused_fwd": 0}

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per process) and bind the kernel library."""
    global _lib
    if _lib is None:
        from torch.utils.cpp_extension import load
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = load(name="selfcorr_raster_fwd", sources=[SOURCE],
                    build_directory=BUILD_DIR, extra_cuda_cflags=CUDA_FLAGS,
                    is_python_module=False)
        lib = ctypes.CDLL(path)
        fn = lib.raster_fused_fwd
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 13 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cull_pad(sigma1: float, sigma2: float) -> float:
    """Bbox cull radius: a face reaches no pixel farther than
    sqrt(sigma * DIST_CUT) from it (pallas_raster.py:1293), with a margin
    for rounding in the squared distance."""
    return math.sqrt(max(sigma1, sigma2) * C.DIST_CUT) * 1.001 + 1e-6


def raster_fused_fwd_cuda(consts: torch.Tensor, image_size: int,
                          sigma1: float, sigma2: float, gamma_d: float,
                          gamma_t: float) -> dict:
    """consts (B, F, 64) float32 on a CUDA device -> the 13 (B, S, S)
    planes of reference.PLANES, computed by the CUDA kernel."""
    if not consts.is_cuda:
        raise ValueError("raster_fused_fwd_cuda needs a CUDA tensor")
    if consts.dtype != torch.float32 or consts.dim() != 3 \
            or consts.shape[-1] != C.K:
        raise ValueError(f"consts must be (B, F, {C.K}) float32, got "
                         f"{tuple(consts.shape)} {consts.dtype}")
    b, f, _ = consts.shape
    s = int(image_size)
    if b < 1 or s < 1:
        raise ValueError(f"empty render: B={b}, S={s}")
    lib = build()
    consts = consts.contiguous()
    out = torch.empty((len(PLANES), b, s, s), dtype=torch.float32,
                      device=consts.device)
    with torch.cuda.device(consts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.raster_fused_fwd(
            consts.data_ptr(), b, f, s, 1.0 / sigma1, 1.0 / sigma2,
            1.0 / gamma_d, 1.0 / gamma_t, C.NEAR, C.FAR,
            1.0 / (C.FAR - C.NEAR), C.BG_EPS, C.EYE_OFFSET,
            sigma1 * C.DIST_CUT, sigma2 * C.DIST_CUT,
            cull_pad(sigma1, sigma2), 1.0 / s, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"raster_fused_fwd launch failed: CUDA error {rc}")
    LAUNCHES["raster_fused_fwd"] += 1
    return dict(zip(PLANES, out.unbind(0)))
