"""Build the port's CUDA sources and bind them with ctypes.

Each source under a `csrc/` directory has a plain C interface and includes no
PyTorch header, so `nvcc` compiles it for sm_90a in seconds into a shared
library under selfcorr_tpu_torch/_build/ (gitignored). `build_all` starts one
`nvcc` per source, all at once, and waits for them; a failed build raises with
the compiler's output. Libraries are named by a hash of their source, the
headers beside it and the flags, and written through a temporary file and a
rename, so a rebuilt source never loads a stale library and concurrent
processes never see a half-written one. nvcc runs with --resource-usage:
the registers, shared memory and spills of each kernel it builds are kept
in LOGS. Nothing here runs at import time:
the CPU tests import every module on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE, "_build")
# -fmad=false: every multiply and add rounds on its own, as the plain
# PyTorch versions' separate operations do
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false",
              "--resource-usage"]
_LINK_FLAGS = ["-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict = {}
LOGS: dict = {}  # {source: nvcc's output} for the sources built here


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")


def library_path(source: str, flags=CUDA_FLAGS) -> str:
    """The library of `source`, named by a hash of the source, the headers
    beside it (*.cuh, which it may include) and the flags."""
    here = os.path.dirname(source)
    headers = sorted(os.path.join(here, n) for n in os.listdir(here)
                     if n.endswith(".cuh"))
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in [source] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_all(sources, flags=CUDA_FLAGS) -> dict:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns {source: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {src: library_path(src, flags) for src in sources}
    jobs = []
    for src, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags, *_LINK_FLAGS, "-o", tmp, src]
        jobs.append((src, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, path, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, path)
            LOGS[src] = log
        else:
            os.unlink(tmp)
            failed.append(f"{os.path.relpath(src, PACKAGE)}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The bound library of `source`, built first if needed (once per
    process)."""
    if source not in _loaded:
        path = build_all([source])[source]
        _loaded[source] = ctypes.CDLL(path)
    return _loaded[source]
