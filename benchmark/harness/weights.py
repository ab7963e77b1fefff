"""The benchmark's weights, made on the device from the seed in one draw,
in the distribution the port initializes from (flax's defaults,
models/init.py there) but not truncated: every Linear and Conv weight
normal with standard deviation 1/sqrt(fan_in), biases zero, norms at
scale 1 and bias 0, BatchNorm statistics at mean 0 and variance 1, the
DINO trunk's pos_embed normal(0.02) and cls_token zero; the prior's
vertices and the rotation head's offset are constants of the
configuration. The reference's modules are built here and filled; the
program's get a copy of the same tensors by name."""
from __future__ import annotations

import math

import torch
import torch.nn as nn

POS_EMBED_STD = 0.02


def _random_leaves(module: nn.Module) -> list:
    """[(tensor, standard deviation)] of the leaves drawn at random, in
    named_modules() order; every other leaf is set to its constant here.
    A module with state of a kind not named here raises."""
    from benchmark.reference.models.heads import PosePredictor
    from benchmark.reference.models.meshnet import MeshParams
    from benchmark.reference.models.vit import DinoViTS8
    leaves = []
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            leaves.append((m.weight, 1.0 / math.sqrt(m.weight[0].numel())))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, MeshParams,
                            PosePredictor)):
            m.reset_parameters()
        elif isinstance(m, DinoViTS8):
            leaves.append((m.pos_embed, POS_EMBED_STD))
            m.cls_token.zero_()
        elif any(True for _ in m.parameters(recurse=False)) or any(
                True for _ in m.buffers(recurse=False)):
            raise TypeError(f"no rule for the state of {name}: "
                            f"{type(m).__name__}")
    return leaves


@torch.no_grad()
def fill(modules: list, seed: int, device) -> None:
    """Set every leaf of `modules` (built on `device`): one normal draw of
    all random leaves from a generator on the device, scaled per leaf."""
    from benchmark.harness.inputs import seed_words
    leaves = [leaf for m in modules for leaf in _random_leaves(m)]
    total = sum(t.numel() for t, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed_words(seed, 0))
    z = torch.randn(total, generator=gen, device=device)
    std = torch.repeat_interleave(
        torch.tensor([s for _, s in leaves], device=device),
        torch.tensor([t.numel() for t, _ in leaves], device=device))
    z.mul_(std)
    at = 0
    for t, _ in leaves:
        t.copy_(z[at:at + t.numel()].view_as(t))
        at += t.numel()


def reference_modules(cfg, constants, seed: int, device):
    """The reference's MeshNet and DINO trunk on `device`, filled from
    `seed`."""
    from benchmark.reference.models.meshnet import MeshNet
    from benchmark.reference.models.vit import DinoViTS8
    with torch.device("meta"):
        model = MeshNet(cfg, constants)
        dino = DinoViTS8(img_size=cfg.img_size, attn_bf16=cfg.dino_attn_bf16)
    model = model.to_empty(device=device)
    dino = dino.to_empty(device=device)
    fill([model, dino], seed, device)
    return model, dino


def load_into(module: nn.Module, state: dict, device) -> nn.Module:
    """`module`, built on the meta device, on `device` holding `state`: its
    non-persistent buffers from its own reset_parameters, every other leaf
    copied from `state` by name (strict)."""
    module = module.to_empty(device=device)
    for m in module.modules():
        if m._non_persistent_buffers_set:
            m.reset_parameters()
    module.load_state_dict(state, strict=True)
    return module
