"""Train state and the train step (counterpart of
selfcorr_tpu/train/step.py).

One step: decompress the uploaded batch, the training forward (all losses,
the fused render through kernels B1 and B2, the frozen DINO trunk through
kernel B3), backward, per-group clipping and the NaN guard, one AdamW
update with the OneCycle learning rates. The metrics stay on the device as
0-d tensors; the caller fetches them when it logs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.models.meshnet import (DeviceConstants, MeshConstants,
                                               MeshNet, StepDraws,
                                               device_constants,
                                               forward_train)
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.train.optim import Optimizer, clip_and_guard
from selfcorr_tpu_torch.utils.weight_convert import (load_pretrained_init,
                                                     load_warm_start)


@dataclass
class TrainState:
    model: MeshNet            # trainable nets + mean_v, in train mode
    dino: DinoViTS8           # frozen
    optimizer: Optimizer
    constants: DeviceConstants
    step: int = 0


def init_state(cfg: Config, constants: MeshConstants, device,
               model: MeshNet | None = None,
               dino: DinoViTS8 | None = None) -> TrainState:
    """Model and DINO trunk initialized from cfg.seed on the CPU (so the
    weights do not depend on the device), or the ones given; then, as the
    JAX package's init_state does (selfcorr_tpu/train/step.py:57-65), the
    pretrained imports (--resnet_init_path, --dino_init_path) and the warm
    start (--warm_start_path), still on the CPU; moved to `device`; the
    optimizer over the model's five groups, its moments at zero."""
    if cfg.dino_bf16:
        raise NotImplementedError(
            "--dino_bf16 (a bfloat16 trunk at rest) is not ported; the "
            "trunk runs in float32 with bfloat16 attention")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        if model is None:
            model = MeshNet(cfg, constants)
        if dino is None:
            dino = DinoViTS8(img_size=cfg.img_size,
                             attn_bf16=cfg.dino_attn_bf16)
    load_pretrained_init(cfg, model, dino)
    if cfg.warm_start_path:
        load_warm_start(cfg, model)
    model = model.to(device).train()
    dino = dino.to(device).eval().requires_grad_(False)
    dino.attn_bf16 = cfg.dino_attn_bf16
    return TrainState(model=model, dino=dino,
                      optimizer=Optimizer(model, cfg),
                      constants=device_constants(constants, device))


def compress_batch_host(batch: dict) -> dict:
    """Pack a host batch into compact dtypes for upload: uint8 img, mask
    and occ, uint16 depth in millimetres rounded to nearest."""
    out = dict(batch)
    out["img"] = np.clip(np.asarray(batch["img"]) * 255.0 + 0.5,
                         0, 255).astype(np.uint8)
    out["mask"] = (np.asarray(batch["mask"]) > 0).astype(np.uint8)
    out["occ"] = (np.asarray(batch["occ"]) > 0).astype(np.uint8)
    out["depth"] = np.clip(np.asarray(batch["depth"]) + 0.5,
                           0, 65535).astype(np.uint16)
    return out


def decompress_batch(batch: dict) -> dict:
    """On the device: the inverse of compress_batch_host (float32 batches
    pass through)."""
    out = dict(batch)
    if batch["img"].dtype == torch.uint8:
        out["img"] = batch["img"].float() / 255.0
    for k in ("mask", "occ", "depth"):
        if batch[k].dtype != torch.float32:
            out[k] = batch[k].float()
    return out


def train_step(state: TrainState, batch: dict, draws: StepDraws,
               cfg: Config) -> dict:
    """One training step on a device batch (float32 or compressed),
    updating `state` in place. Returns the metrics as 0-d device tensors:
    the aux losses, the three group gradient norms and bad_grad."""
    batch = decompress_batch(batch)
    model = state.model
    model.zero_grad(set_to_none=True)
    total, aux = forward_train(model, state.dino, batch, state.constants,
                               cfg, state.step, draws)
    total.backward()
    for p in model.parameters():   # every parameter takes part in the update
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norms, bad = clip_and_guard(model)
    state.optimizer.step(state.step)
    state.step += 1
    return {**{k: v.detach() for k, v in aux.items()}, **norms,
            "bad_grad": bad.float()}
