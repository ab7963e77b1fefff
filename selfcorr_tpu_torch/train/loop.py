"""Training loop and the entry point (counterpart of
selfcorr_tpu/train/loop.py Trainer.train):

  python -m selfcorr_tpu_torch.train --flagfile config/wild6d/laptop.txt \
      --dataset_name synthetic --total_iters 6 --batch_log_interval 1 \
      [--device cpu]

Runs on CUDA unless --device cpu is given; a missing GPU is an error. Each
step draws from a generator seeded by (seed, step), the counterpart of the
JAX loop's fold_in(PRNGKey(seed + 1), step). Batches come from a thread
loader, packed to compact dtypes (--compact_transfer) and uploaded from
pinned memory. Every batch_log_interval steps the metrics are fetched in
one transfer and printed; last_logged_loss keeps the total loss of the last
log. Checkpoints, resume and image logging are not ported yet: the Trainer
says so at its start, and flags that ask for other work the port does not do
yet raise (configs.refuse_unported).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from selfcorr_tpu_torch.configs import Config, refuse_unported
from selfcorr_tpu_torch.data.loader import BATCH_KEYS, TrainLoader
from selfcorr_tpu_torch.models.meshnet import build_mesh_constants, draw_step
from selfcorr_tpu_torch.train.step import (compress_batch_host, init_state,
                                           train_step)
from selfcorr_tpu_torch.utils.device import resolve_device, set_fp32_precision


def make_train_dataset(cfg: Config):
    if cfg.dataset_name == "synthetic":
        from selfcorr_tpu_torch.data.synthetic import SyntheticTrain
        return SyntheticTrain(cfg, seed=cfg.seed, shape=cfg.synthetic_shape)
    raise NotImplementedError(
        f"dataset {cfg.dataset_name!r}: only 'synthetic' is ported so far; "
        f"the Wild6D / NOCS / CUB readers come in a later slice")


def step_generator(seed: int, step: int) -> torch.Generator:
    """The draws of step `step` of a run seeded `seed`."""
    return torch.Generator().manual_seed((seed + 1) * 1_000_003 + step)


class Trainer:
    def __init__(self, cfg: Config):
        refuse_unported(cfg, train=True)
        print(f"[train] this port writes no checkpoint (--save_freq "
              f"{cfg.save_freq}) and logs no images (--vis_freq "
              f"{cfg.vis_freq}, --logger {cfg.logger}) yet", flush=True)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        set_fp32_precision()
        self.constants = build_mesh_constants(cfg)
        self.state = init_state(cfg, self.constants, self.device)
        self.last_logged_loss = None    # total_loss at the last log step
        self.logged = []                # (step, {metric: value}) per log

    def upload(self, batch: dict) -> dict:
        out = {}
        for k in BATCH_KEYS:
            t = torch.as_tensor(np.ascontiguousarray(batch[k]))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def train(self):
        cfg = self.cfg
        start = self.state.step
        loader = TrainLoader(make_train_dataset(cfg), cfg, start=start,
                             host_transform=(compress_batch_host
                                             if cfg.compact_transfer
                                             else None))
        try:
            self._loop(loader, start)
        finally:
            loader.close()

    def _loop(self, loader, start: int):
        cfg = self.cfg
        t0 = time.time()
        for i, host in enumerate(loader, 1):
            step_idx = start + i - 1
            batch = self.upload(host)
            b = batch["img"].shape[0]
            draws = draw_step(step_generator(cfg.seed, step_idx), cfg, b)
            metrics = train_step(self.state, batch, draws, cfg)
            if (step_idx + 1) % cfg.batch_log_interval:
                continue
            names = sorted(metrics)
            packed = torch.stack([metrics[n].float().reshape(())
                                  for n in names]).cpu().tolist()
            vals = dict(zip(names, packed))
            self.logged.append((step_idx + 1, vals))
            self.last_logged_loss = vals["total_loss"]
            dt = (time.time() - t0) / cfg.batch_log_interval
            print(f"iter {step_idx + 1}/{cfg.total_iters} "
                  f"loss {vals['total_loss']:.4f} {dt * 1000:.0f} ms/iter "
                  f"({b / dt:.1f} imgs/s)", flush=True)
            t0 = time.time()


def main(argv) -> Trainer:
    """argv[0] is the program name, as in sys.argv."""
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(argv[1:])
    resolve_device(cfg.device)
    trainer = Trainer(cfg)
    trainer.train()
    return trainer
