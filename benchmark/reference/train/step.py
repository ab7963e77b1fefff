"""The reference's training step: the port's train/step.py train_step,
alone or with a process group (parallel/__init__.py all_mean_), written
plainly over the reference's modules (frozen copy): decompress nothing
(the benchmark's batches are float32), the training forward with every
loss, backward, the per-group clipping and the NaN guard, one AdamW update
with the OneCycle learning rates.

A step runs over shards, each one rank's rows and draws; one shard is the
single-card step. Every shard runs the forward and backward from the same
parameters and the same running statistics, its BatchNorm normalising
with the shard's own batch statistics, as the port's ranks and the JAX
package's shard_map step do (the source wraps its net in SyncBatchNorm
instead). The shards' gradients, aux losses and BatchNorm running
statistics are then averaged, and one clip, guard and update follows.

The shards may all be in this process (`shards` holds every one) or
spread over processes, each passing its own and a `reduce` that sums a
flat buffer over them in place (torch.distributed.all_reduce); `world` is
the number of shards in all."""
from __future__ import annotations

import torch

from benchmark.reference.models.meshnet import forward_train
from benchmark.reference.train.optim import clip_and_guard


def running_stats(model) -> list:
    """The BatchNorm running means and variances (the update counts are
    not averaged: every shard advances them alike)."""
    return [b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def train_step(model, dino, optimizer, constants, shards: list, cfg,
               step: int, world: int | None = None, reduce=None) -> tuple:
    """One step at update count `step` over `shards` [(batch, StepDraws)],
    in place on `model` and `optimizer`. Returns (the aux losses averaged
    over the shards, as 0-d tensors; {parameter name: its averaged
    gradient as the optimizer takes it, after the clip and the guard})."""
    params = [p for _, p in model.named_parameters()]
    stats = running_stats(model)
    start = [s.detach().clone() for s in stats]
    total, names = None, None
    for batch, draws in shards:
        with torch.no_grad():
            for s, s0 in zip(stats, start):
                s.copy_(s0)
        model.zero_grad(set_to_none=True)
        _, aux = forward_train(model, dino, batch, constants, cfg, step,
                               draws)
        aux["total_loss"].backward()
        names = sorted(aux)
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1) for p in params]
            + [torch.stack([aux[k].detach() for k in names])]
            + [s.detach().reshape(-1) for s in stats])
        total = flat if total is None else total + flat
    if reduce is not None:
        reduce(total)
    total = total / (world or len(shards))
    sizes = [p.numel() for p in params] + [len(names)] \
        + [s.numel() for s in stats]
    pieces = total.split(sizes)
    with torch.no_grad():
        for p, g in zip(params, pieces):
            p.grad = g.view_as(p).clone()
        for s, v in zip(stats, pieces[len(params) + 1:]):
            s.copy_(v.view_as(s))
    losses = pieces[len(params)]
    clip_and_guard(model)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    optimizer.step(step)
    return {k: losses[i] for i, k in enumerate(names)}, grads
