"""Frozen DINO ViT-S/8 dense feature extractor (counterpart of
selfcorr_tpu/models/vit.py).

ViT-Small (dim 384, 6 heads of 64, MLP ratio 4, LayerNorm eps 1e-6, exact
GELU), patch 8, returning the keys of block 9 as dense features:
(B, H/8, W/8, 384), channel = head * 64 + d. Only blocks 0-9 run (the
reference computes 12 and reads block 9's keys), and block 9 computes only
its qkv projection: its attention output is unused (XLA drops it in the JAX
package). Parameter names are the released checkpoint's (patch_embed.proj,
cls_token, pos_embed, blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}), the keys selfcorr_tpu/utils/weight_convert.py convert_dino_vits8
reads.

Attention goes through ops/attention.py: with attn_bf16 (the
`dino_attn_bf16` default) q, k and v are rounded to bf16 and CUDA tensors run
kernel B3; block 9's keys are returned as those bf16 values in float32, as
in the JAX package. The ragged token count (1025 at 256^2) needs no padding:
the kernel masks its tail.

A trunk cast to bfloat16 (--dino_bf16) computes every layer in bfloat16 on
a bfloat16 image, as flax applies bf16 parameters to a bf16 input, and
rounds where flax does: a dense layer's or the patch embedding's product
before its bias, GELU after each operation (dense, gelu); its LayerNorms
(statistics in float32, the output in bf16) already agree. Its q, k and v
are bf16 whatever attn_bf16 says, so its attention always takes the flash
route (B3 on the card).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.ops.attention import attention

SQRT_HALF_BF16 = 0.70703125     # sqrt(0.5) rounded to bfloat16


def dense(layer: nn.Linear, x):
    """layer(x); in bfloat16 the product is rounded before the bias is
    added, as flax Dense rounds (dot_general, then + bias)."""
    if x.dtype == torch.bfloat16:
        return F.linear(x, layer.weight) + layer.bias
    return layer(x)


def gelu(x):
    """Exact GELU; in bfloat16 with jax.nn.gelu's roundings: 0.5 x times
    erfc(-x sqrt(0.5)), each operation rounded, sqrt(0.5) rounded first."""
    if x.dtype == torch.bfloat16:
        return (0.5 * x) * torch.special.erfc(-x * SQRT_HALF_BF16)
    return F.gelu(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return dense(self.fc2, gelu(dense(self.fc1, x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def qkv_heads(self, x, attn_bf16: bool):
        """x (B, T, C) -> q, k, v as (B, T, heads, d) views of one tensor,
        rounded to bf16 under attn_bf16."""
        b, t, c = x.shape
        qkv = dense(self.qkv, x)
        if attn_bf16:
            qkv = qkv.bfloat16()
        qkv = qkv.reshape(b, t, 3, self.num_heads, c // self.num_heads)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def forward(self, x, attn_bf16: bool):
        b, t, c = x.shape
        q, k, v = self.qkv_heads(x, attn_bf16)
        y = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        y = y.transpose(1, 2).reshape(b, t, c).to(x.dtype)
        return dense(self.proj, y)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, attn_bf16: bool):
        x = x + self.attn(self.norm1(x), attn_bf16)
        return x + self.mlp(self.norm2(x))

    def keys(self, x, attn_bf16: bool):
        """Only this block's keys, (B, T, heads, d) in x's dtype."""
        _, k, _ = self.attn.qkv_heads(self.norm1(x), attn_bf16)
        return k.to(x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class DinoViTS8(nn.Module):
    """img (B, H, W, 3) -> block `feature_layer`'s keys (B, H/8, W/8, 384).
    img_size fixes the position-embedding grid."""

    def __init__(self, img_size: int = 256, dim: int = 384,
                 num_heads: int = 6, patch_size: int = 8,
                 feature_layer: int = 9, attn_bf16: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.attn_bf16 = attn_bf16
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(dim, patch_size)
        # zeros until models/init.py draws pos_embed, as flax does
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList([Block(dim, num_heads)
                                     for _ in range(feature_layer + 1)])

    @property
    def dtype(self) -> torch.dtype:
        """The trunk's parameter dtype: float32, or bfloat16 under
        --dino_bf16 (train/step.py init_state)."""
        return self.pos_embed.dtype

    def forward(self, img):
        b, h, w, _ = img.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        pe = self.patch_embed.proj
        x = img.permute(0, 3, 1, 2)
        if x.dtype == torch.bfloat16:   # the product rounded before the bias
            x = F.conv2d(x, pe.weight, stride=pe.stride) \
                + pe.bias[:, None, None]
        else:
            x = pe(x)
        x = x.flatten(2).transpose(1, 2)                   # (B, gh*gw, C)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], 1)
        x = x + self.pos_embed
        for blk in self.blocks[:-1]:
            x = blk(x, self.attn_bf16)
        k = self.blocks[-1].keys(x, self.attn_bf16)        # (B, T, h, d)
        return k[:, 1:gh * gw + 1].reshape(b, gh, gw, -1)
