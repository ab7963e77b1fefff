"""Exact 3D box IoU through the repo's C++ clipper (native/box3d_iou.cpp),
bound with ctypes (counterpart of selfcorr_tpu/eval/box3d_native.py).

The library is built at first use by g++ with native/Makefile's flags into
selfcorr_tpu_torch/_build/ (gitignored), named by a hash of the source and
the flags, and written through a temporary file and a rename. A build that
fails raises: the NOCS metrics have no second IoU, since scipy's
(eval/box3d.py, the tests' plain version) differs from the clipper by
~1e-4, which moves an IoU near 0.25 or 0.5 into another bucket.
Boxes are (9, 3) float64 vertices, centre first (eval/box3d.Box3D).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "box3d_iou.cpp")
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib = None


def build() -> ctypes.CDLL:
    """The bound library, built first if it is missing (once a process)."""
    global _lib
    if _lib is not None:
        return _lib
    from selfcorr_tpu_torch.utils.cuda_build import BUILD_DIR, library_path
    path = library_path(SOURCE, FLAGS)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.box3d_iou.restype = ctypes.c_double
    lib.box3d_iou.argtypes = [dptr, dptr]
    lib.box3d_iou_batch.restype = None
    lib.box3d_iou_batch.argtypes = [dptr, dptr, ctypes.c_int, dptr]
    lib.box3d_iou_max.restype = ctypes.c_double
    lib.box3d_iou_max.argtypes = [dptr, dptr, ctypes.c_int]
    _lib = lib
    return lib


def _boxes(a, n_dims: int) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != n_dims or a.shape[-2:] != (9, 3):
        raise ValueError(f"expected {'(N, ' if n_dims == 3 else '('}9, 3) "
                         f"box vertices, got {a.shape}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def iou(verts_a, verts_b) -> float:
    a, b = _boxes(verts_a, 2), _boxes(verts_b, 2)
    return float(build().box3d_iou(_ptr(a), _ptr(b)))


def iou_batch(boxes_a, boxes_b) -> np.ndarray:
    """(N,) IoU of each pair of (N, 9, 3) boxes."""
    a, b = _boxes(boxes_a, 3), _boxes(boxes_b, 3)
    if len(a) != len(b):
        raise ValueError(f"{len(a)} boxes against {len(b)}")
    out = np.empty(len(a), np.float64)
    build().box3d_iou_batch(_ptr(a), _ptr(b), len(a), _ptr(out))
    return out


def iou_max(verts_pred, verts_gts) -> float:
    """Largest IoU of one box against (N, 9, 3) candidates."""
    p, g = _boxes(verts_pred, 2), _boxes(verts_gts, 3)
    return float(build().box3d_iou_max(_ptr(p), _ptr(g), len(g)))
