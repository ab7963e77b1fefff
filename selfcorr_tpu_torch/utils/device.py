"""Device selection and numeric settings for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The torch device an entry point runs on. Asking for CUDA on a machine
    without it is an error, never a silent switch to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available "
            f"(torch.cuda.is_available() is False); pass --device cpu to "
            f"run on the CPU")
    return dev


def set_fp32_precision() -> None:
    """Keep convolutions and matmuls in full float32. cuDNN allows TF32
    for convolutions by default, which keeps ~3 decimal digits and would
    break parity with the CPU and with the JAX package."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
