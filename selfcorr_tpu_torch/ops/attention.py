"""Attention for the frozen DINO trunk.

`attention(q, k, v)` takes (B, H, T, D) query, key and value tensors and
returns softmax(q k^T / sqrt(D)) v as (B, H, T, D):

  * bfloat16 inputs (the trunk's `dino_attn_bf16` default) compute what the
    TPU library flash kernel computes (jax.experimental.pallas.ops.tpu.
    flash_attention, called at selfcorr_tpu/models/vit.py:72): scores in f32
    from bf16 inputs, an online softmax in f32 over tiles of BLOCK_K keys, p
    rounded to bf16 before the p v product, the output rounded to bf16. CUDA
    tensors go to kernel B3 (csrc/flash_attn.cu) always, CPU tensors to
    `flash_attention_plain`, which does the same roundings in plain PyTorch;
  * float32 inputs take the plain materialized softmax, the JAX package's
    XLA path (`jax.nn.dot_product_attention`). It is the CPU reference of the
    f32 trunk; on a CUDA tensor it raises, as kernel B3 is bf16 only.

The build and the launch happen at the first call, never at import.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from selfcorr_tpu_torch.utils import cuda_build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attn.cu")
BLOCK_K = 128     # keys per tile of the online softmax (the kernel's BK)
HEAD_DIM = 64     # the kernel's head dimension

# launches of the kernel, counted by its wrapper where it launches
LAUNCHES = {"dino_flash_attn": 0}

_fn = None


def build():
    """Compile (once per process) and bind the kernel."""
    global _fn
    if _fn is None:
        fn = cuda_build.load(SOURCE).flash_attn_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 12 + [ctypes.c_float,
                                                      ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention_plain(q, k, v) -> torch.Tensor:
    """(B, H, T, D) bfloat16 q, k, v -> (B, H, T, D) bfloat16, the kernel's
    arithmetic in plain PyTorch: keys in tiles of BLOCK_K, running max and
    f32 running sum, the accumulator rescaled by exp(m_old - m_new), p
    rounded to bf16 for the product, out = acc * (1 / l) rounded to bf16."""
    t, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), float("-inf"), device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, BLOCK_K):
        kb = k[..., k0:k0 + BLOCK_K, :].float()
        vb = v[..., k0:k0 + BLOCK_K, :].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = alpha * lsum + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.bfloat16().float(), vb)
        m = m_new
    return (acc * (1.0 / lsum)).bfloat16()


def attention_f32_plain(q, k, v) -> torch.Tensor:
    """(B, H, T, D) float32 -> (B, H, T, D) float32, materialized softmax."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _strides(x):
    return x.stride(0), x.stride(1), x.stride(2)


def flash_attention_cuda(q, k, v) -> torch.Tensor:
    """Kernel B3 on (B, H, T, 64) bfloat16 CUDA tensors (any strides with a
    contiguous last dimension and 16-byte aligned rows). Returns a
    (B, H, T, 64) bfloat16 view of a (B, T, H, 64) buffer, so that
    `.transpose(1, 2).reshape(B, T, H * 64)` is free."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4:
            raise ValueError(f"{name} must be a (B, H, T, D) bfloat16 CUDA "
                             f"tensor, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
        if x.shape != q.shape or x.shape[-1] != HEAD_DIM:
            raise ValueError(f"q, k, v must share one (B, H, T, {HEAD_DIM}) "
                             f"shape, got {tuple(x.shape)}")
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
                st % 8 for st in _strides(x)):
            raise ValueError(f"{name}: the last dimension must be "
                             f"contiguous and rows 16-byte aligned")
    b, h, t, d = q.shape
    fn = build()
    out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q.device)
    o = out.permute(0, 2, 1, 3)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                t, *_strides(q), *_strides(k), *_strides(v), *_strides(o),
                1.0 / math.sqrt(d), stream)
    if rc >= 1000:
        raise RuntimeError(f"flash_attn: cuTensorMapEncodeTiled refused the "
                           f"views: CUresult {rc - 1000}")
    if rc != 0:
        raise RuntimeError(f"flash_attn launch failed: CUDA error {rc}")
    LAUNCHES["dino_flash_attn"] += 1
    return o


def attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D) tensors; see the module
    docstring for the routes."""
    if q.dtype == torch.bfloat16:
        if q.device.type == "cuda":
            return flash_attention_cuda(q, k, v)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v)
    elif q.dtype == torch.float32:
        if q.device.type == "cpu":
            return attention_f32_plain(q, k, v)
        raise ValueError("float32 attention is the CPU reference of the f32 "
                         "trunk; on the card the trunk runs kernel B3 in "
                         "bfloat16 (dino_attn_bf16)")
    raise ValueError(f"no attention for {q.dtype} on {q.device}")
