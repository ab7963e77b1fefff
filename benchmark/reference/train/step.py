"""The reference's training step: the port's train/step.py train_step on
one rank, over the reference's plain modules (frozen copy): decompress
nothing (the benchmark's batches are float32), the training forward with
every loss, backward, the per-group clipping and the NaN guard, one AdamW
update with the OneCycle learning rates."""
from __future__ import annotations

import torch

from benchmark.reference.models.meshnet import StepDraws, forward_train
from benchmark.reference.train.optim import clip_and_guard


def train_step(model, dino, optimizer, constants, batch: dict,
               draws: StepDraws, cfg, step: int) -> tuple:
    """One step at update count `step`, in place on `model` and
    `optimizer`. Returns (aux losses as 0-d tensors, {parameter name: its
    gradient as the optimizer takes it, after the clip and the guard})."""
    model.zero_grad(set_to_none=True)
    _, aux = forward_train(model, dino, batch, constants, cfg, step, draws)
    aux["total_loss"].backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_and_guard(model)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    optimizer.step(step)
    return {k: v.detach() for k, v in aux.items()}, grads
