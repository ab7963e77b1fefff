"""Attention of the reference's DINO trunk, plain PyTorch on any device
(frozen copy of the port's ops/attention.py without its kernel route).

`attention(q, k, v)` takes (B, H, T, D) tensors and returns softmax(q k^T /
sqrt(D)) v: bfloat16 inputs (the configuration's `dino_attn_bf16`) take
`flash_attention_plain`, the roundings the configuration states (scores in
f32 from bf16 inputs, an online softmax in f32 over tiles of BLOCK_K keys, p
rounded to bf16 before the p v product, the output rounded to bf16);
float32 inputs the materialized softmax.
"""
from __future__ import annotations

import math

import torch

BLOCK_K = 128     # keys per tile of the online softmax


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


def attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D) tensors."""
    if q.dtype == torch.bfloat16:
        return flash_attention_plain(q, k, v)
    if q.dtype == torch.float32:
        return attention_f32_plain(q, k, v)
    raise ValueError(f"no attention for {q.dtype}")
