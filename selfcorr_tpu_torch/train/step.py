"""Train state and the train step (counterpart of
selfcorr_tpu/train/step.py).

One step: decompress the uploaded batch, the training forward (all losses,
the fused render through kernels B1 and B2, the frozen DINO trunk through
kernel B3), backward, per-group clipping and the NaN guard, one AdamW
update with the OneCycle learning rates. The metrics stay on the device as
0-d tensors; the caller fetches them when it logs. Across ranks (a process
group) each rank steps on its own rows, and the gradients, aux losses and
BatchNorm running statistics are averaged before the clip, as the JAX
package's train_step_sharded pmeans them (selfcorr_tpu/train/step.py:175).
Each phase is a span of utils/tracing.py, the whole call a unit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.models.init import (build_like_jax, init_generator,
                                            init_model)
from selfcorr_tpu_torch.models.meshnet import (DeviceConstants, MeshConstants,
                                               MeshNet, StepDraws,
                                               device_constants,
                                               forward_train)
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.parallel import all_mean_
from selfcorr_tpu_torch.train.optim import Optimizer, clip_and_guard
from selfcorr_tpu_torch.utils.tracing import span
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
    """Model and DINO trunk initialized as the JAX package's are, from
    cfg.seed on the CPU, so the weights do not depend on the device
    (init_model, then the trunk from the same generator), or the ones
    given; then, as the JAX package's init_state does
    (selfcorr_tpu/train/step.py:57-65), the
    pretrained imports (--resnet_init_path, --dino_init_path) and the warm
    start (--warm_start_path), still on the CPU; with --dino_bf16 the
    frozen trunk cast to bfloat16 once, at rest (selfcorr_tpu/train/
    step.py:66-72); moved to `device`; the optimizer over the model's five
    groups, its moments at zero."""
    generator = init_generator(cfg)
    if model is None:
        model = init_model(cfg, constants, generator)
    if dino is None:
        dino = build_like_jax(lambda: DinoViTS8(
            img_size=cfg.img_size, attn_bf16=cfg.dino_attn_bf16), generator)
    load_pretrained_init(cfg, model, dino)
    if cfg.warm_start_path:
        load_warm_start(cfg, model)
    if cfg.dino_bf16:
        dino = dino.to(torch.bfloat16)
    model = model.to(device).train()
    dino = dino.to(device).eval().requires_grad_(False)
    dino.attn_bf16 = cfg.dino_attn_bf16
    return TrainState(model=model, dino=dino,
                      optimizer=Optimizer(model, cfg),
                      constants=device_constants(constants, device))


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


def running_stats(model: torch.nn.Module) -> list:
    """The BatchNorm running means and variances of `model` (not the
    update counts, which every rank advances alike)."""
    return [b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def train_step(state: TrainState, batch: dict, draws: StepDraws,
               cfg: Config, group=None) -> dict:
    """One training step on a device batch (float32 or compressed),
    updating `state` in place. With a process group, `batch` and `draws`
    are this rank's, and the ranks' gradients, aux losses and BatchNorm
    running statistics are averaged (one coalesced all-reduce) before the
    clip and the update, which every rank then takes alike. Returns the
    metrics as 0-d device tensors: the aux losses, the three group
    gradient norms and bad_grad."""
    with span("train_step"):
        with span("step.decompress"):
            batch = decompress_batch(batch)
        model = state.model
        model.zero_grad(set_to_none=True)
        with span("step.forward"):
            total, aux = forward_train(model, state.dino, batch,
                                       state.constants, cfg, state.step,
                                       draws)
        with span("step.backward"):
            total.backward()
            for p in model.parameters():   # every parameter takes part in
                if p.grad is None:         # the update
                    p.grad = torch.zeros_like(p)
        if group is not None:
            with span("step.all_mean"):
                names = sorted(aux)
                losses = torch.stack([aux[k].detach() for k in names])
                all_mean_([p.grad for p in model.parameters()] + [losses]
                          + running_stats(model), group)
                aux = dict(zip(names, losses.unbind()))
        with span("step.clip"):
            norms, bad = clip_and_guard(model)
        with span("step.optimizer"):
            state.optimizer.step(state.step)
        state.step += 1
        return {**{k: v.detach() for k, v in aux.items()}, **norms,
                "bad_grad": bad.float()}
