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


def upload(tensors, device) -> list:
    """`tensors` on `device`, with no copy that makes the host wait for the
    device. The CPU tensors are packed into one flat buffer per dtype,
    page-locked where the device is a GPU, which goes up in one
    non_blocking copy; each comes back as a view of it in its own shape.
    Tensors on another device are moved with .to. PyTorch's caching host
    allocator keeps a page-locked buffer until its copy has run, so the
    caller may drop or change its tensors at once. A non_blocking copy from
    pageable memory is no such copy: it may still wait."""
    device = torch.device(device)
    out = list(tensors)
    packs = {}
    for i, t in enumerate(out):
        if t.device.type == "cpu":
            packs.setdefault(t.dtype, []).append(i)
        else:
            out[i] = t.to(device)
    for dtype, idx in packs.items():
        sizes = [out[i].numel() for i in idx]
        flat = torch.empty(sum(sizes), dtype=dtype,
                           pin_memory=device.type == "cuda")
        torch.cat([out[i].reshape(-1) for i in idx], out=flat)
        flat = flat.to(device, non_blocking=True)
        for i, piece in zip(idx, flat.split(sizes)):
            out[i] = piece.view(out[i].shape)
    return out
