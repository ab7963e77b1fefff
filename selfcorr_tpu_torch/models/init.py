"""Parameter initialization as the JAX package's modules get it: flax's
defaults, drawn from an explicit torch.Generator.

The JAX package sets no kernel_init or bias_init anywhere, so every
nn.Dense and nn.Conv starts from flax's lecun_normal (a unit normal
truncated to +-2, times 1/sqrt(fan_in)/0.8796..., which restores the unit
variance the truncation takes away) and a zero bias; the DINO trunk's
pos_embed from normal(0.02) and its cls_token at zero
(selfcorr_tpu/models/vit.py:179-181); BatchNorm and LayerNorm at scale 1,
bias 0, BatchNorm's statistics at mean 0, variance 1. PyTorch's own
reset_parameters (kaiming_uniform(a=sqrt(5)), uniform biases) gives
weights of 1/sqrt(3) that scale and non-zero biases, under which the
rotation head answers nearly one pose whatever the image (ROADMAP C.17).

Torch generators cannot replay threefry draws, so what matches is each
parameter's distribution, not its values. build_like_jax constructs a
module on the meta device (no draw from the global generator), puts it on
the CPU and sets every parameter and buffer with init_like_jax_, walking
named_modules() in order, so a seed gives the same weights on any device.
A module type with parameters or buffers that the walk does not know
raises, so a new module cannot keep torch's defaults unnoticed.
"""
from __future__ import annotations

import math
from typing import Callable, TypeVar

import torch
import torch.nn as nn

from selfcorr_tpu_torch.models.heads import PosePredictor
from selfcorr_tpu_torch.models.meshnet import (MeshConstants, MeshNet,
                                               MeshParams)
from selfcorr_tpu_torch.models.vit import DinoViTS8

# the standard deviation of a unit normal truncated to [-2, 2]
# (flax's variance_scaling, truncated_normal)
TRUNC_STD = 0.87962566103423978
POS_EMBED_STD = 0.02
M = TypeVar("M", bound=nn.Module)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's lecun_normal in place: fan_in is weight[0].numel(), which is
    the input width of nn.Linear and PointConv and in * kh * kw of
    nn.Conv2d, flax's kernel fan-in for the same layer."""
    fan_in = weight[0].numel()
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return weight.mul_(1.0 / math.sqrt(fan_in) / TRUNC_STD)


def _owns_state(m: nn.Module) -> bool:
    return any(True for _ in m.parameters(recurse=False)) or any(
        True for _ in m.buffers(recurse=False))


@torch.no_grad()
def init_like_jax_(module: M, generator: torch.Generator) -> M:
    """Every parameter and buffer of `module` as flax initializes its
    counterpart (module docstring), in named_modules() order; returns
    `module`. Raises TypeError on a module type with parameters or buffers
    of its own that is not one of those below."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, MeshParams,
                            PosePredictor)):
            m.reset_parameters()      # constants: no draw
        elif isinstance(m, DinoViTS8):
            nn.init.normal_(m.pos_embed, 0.0, POS_EMBED_STD,
                            generator=generator)
            m.cls_token.zero_()
        elif _owns_state(m):
            raise TypeError(f"init_like_jax_: {name or 'the module'} is a "
                            f"{type(m).__name__}, whose parameters or "
                            f"buffers it does not know how flax initializes")
    return module


def build_like_jax(make: Callable[[], M], generator: torch.Generator) -> M:
    """make() built on the meta device (nothing drawn, nothing computed),
    then on the CPU with init_like_jax_ from `generator`."""
    with torch.device("meta"):
        module = make()
    return init_like_jax_(module.to_empty(device="cpu"), generator)


def init_generator(cfg) -> torch.Generator:
    """The CPU generator the weights of a run seeded cfg.seed draw from."""
    return torch.Generator().manual_seed(cfg.seed)


def init_model(cfg, constants: MeshConstants,
               generator: torch.Generator | None = None) -> MeshNet:
    """MeshNet as the JAX package initializes it, on the CPU, from
    `generator` (by default a fresh init_generator(cfg)): the evaluation's
    random weights are the training run's first ones."""
    if generator is None:
        generator = init_generator(cfg)
    return build_like_jax(lambda: MeshNet(cfg, constants), generator)
