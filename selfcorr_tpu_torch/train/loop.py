"""Training loop and the entry point (counterpart of
selfcorr_tpu/train/loop.py Trainer.train):

  python -m selfcorr_tpu_torch.train --flagfile config/wild6d/laptop.txt \
      --dataset_path <Wild6D>/laptop --train_list <list> \
      [--checkpoint_dir log --name exp] [--save_freq 2000] [--device cpu]

The data is Wild6D, NOCS, CUB or the synthetic videos (--dataset_name).

Runs on CUDA unless --device cpu is given; a missing GPU is an error. The
run's directory is checkpoint_dir/name: config.txt (every flag), the scalar
log (TensorBoard when it is installed) and ckpt/<step>/ (utils/checkpoint).
A Trainer over a directory that holds a checkpoint resumes from its latest
step. Each step draws from a generator seeded by (seed, step), the
counterpart of the JAX loop's fold_in(PRNGKey(seed + 1), step). Batches come
from the loader (threads, or with --loader_processes spawn-started worker
processes: run the entry point from a module or a file, data/loader.py),
packed to compact dtypes (--compact_transfer) and uploaded from pinned
memory; as in the JAX package, a resumed process starts
the dataset's sample stream afresh. Every batch_log_interval steps the
metrics are fetched in one transfer, logged and printed; last_logged_loss
keeps the total loss of the last log. A checkpoint is written every
save_freq steps and at the end; every vis_freq steps the image panels of
the step's first two frames go to the writer (add_image) and the mean
mesh to <run>/<step>-iter-mean-mesh.obj (_log_images); the time of both is
left out of the printed rate. Flags that ask for work the port does not do
yet raise (configs.refuse_unported).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from selfcorr_tpu_torch.configs import Config, refuse_unported
from selfcorr_tpu_torch.data.loader import (BATCH_KEYS, TrainLoader,
                                            compress_batch_host)
from selfcorr_tpu_torch.models.meshnet import (build_mesh_constants,
                                               draw_step, forward_vis)
from selfcorr_tpu_torch.ops.mesh_ops import save_obj
from selfcorr_tpu_torch.train.step import (decompress_batch, init_state,
                                           train_step)
from selfcorr_tpu_torch.utils import checkpoint as ckpt
from selfcorr_tpu_torch.utils.device import resolve_device, set_fp32_precision
from selfcorr_tpu_torch.utils.logging import (log_metrics, make_writer,
                                              write_config_snapshot)
from selfcorr_tpu_torch.utils.vis import train_panels


def make_train_dataset(cfg: Config):
    if cfg.dataset_name == "Wild6D":
        from selfcorr_tpu_torch.data.wild6d import Wild6DTrain
        return Wild6DTrain(cfg, seed=cfg.seed)
    if cfg.dataset_name == "synthetic":
        from selfcorr_tpu_torch.data.synthetic import SyntheticTrain
        return SyntheticTrain(cfg, seed=cfg.seed, shape=cfg.synthetic_shape)
    if cfg.dataset_name == "nocs":
        from selfcorr_tpu_torch.data.nocs import NOCSTrain
        return NOCSTrain(cfg, seed=cfg.seed)
    if cfg.dataset_name == "cub":
        from selfcorr_tpu_torch.data.cub import CUBTrain
        return CUBTrain(cfg, seed=cfg.seed)
    raise ValueError(f"unknown dataset {cfg.dataset_name!r}: Wild6D, "
                     f"synthetic, nocs or cub")


def step_generator(seed: int, step: int) -> torch.Generator:
    """The draws of step `step` of a run seeded `seed`."""
    return torch.Generator().manual_seed((seed + 1) * 1_000_003 + step)


class Trainer:
    def __init__(self, cfg: Config):
        refuse_unported(cfg, train=True)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        set_fp32_precision()
        self.run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")
        write_config_snapshot(self.run_dir, cfg)
        self.constants = build_mesh_constants(cfg)
        self.state = init_state(cfg, self.constants, self.device)
        start = ckpt.latest_step(self.ckpt_dir)
        if start is not None:
            print(f"resuming from checkpoint step {start}", flush=True)
            ckpt.restore_state(self.ckpt_dir, self.state, start)
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

    def save(self, step: int) -> None:
        path = ckpt.save_state(self.ckpt_dir, self.state, step)
        print(f"saved checkpoint at step {step} ({path})", flush=True)

    def train(self):
        cfg = self.cfg
        start = self.state.step
        writer = make_writer(self.run_dir)
        print(f"[train] scalars go to {type(writer).__name__} in "
              f"{self.run_dir}", flush=True)
        loader = TrainLoader(make_train_dataset(cfg), cfg, start=start,
                             host_transform=(compress_batch_host
                                             if cfg.compact_transfer
                                             else None))
        try:
            self._loop(loader, writer, start)
        finally:
            loader.close()
            writer.close()
        if ckpt.latest_step(self.ckpt_dir) != self.state.step:
            self.save(self.state.step)

    def _loop(self, loader, writer, start: int):
        cfg = self.cfg
        t0 = time.time()
        overhead = 0.0      # vis and save time since the last log, not in
                            # the rate
        for i, host in enumerate(loader, 1):
            step_idx = start + i - 1
            batch = self.upload(host)
            b = batch["img"].shape[0]
            draws = draw_step(step_generator(cfg.seed, step_idx), cfg, b)
            metrics = train_step(self.state, batch, draws, cfg)
            if (step_idx + 1) % cfg.batch_log_interval == 0:
                names = sorted(metrics)
                packed = torch.stack([metrics[n].float().reshape(())
                                      for n in names]).cpu().tolist()
                vals = dict(zip(names, packed))
                self.logged.append((step_idx + 1, vals))
                self.last_logged_loss = vals["total_loss"]
                log_metrics(writer, vals, step_idx)
                dt = (time.time() - t0 - overhead) / cfg.batch_log_interval
                print(f"iter {step_idx + 1}/{cfg.total_iters} "
                      f"loss {vals['total_loss']:.4f} {dt * 1000:.0f} "
                      f"ms/iter ({b / dt:.1f} imgs/s)", flush=True)
                t0 = time.time()
                overhead = 0.0
            if (step_idx + 1) % cfg.vis_freq == 0:
                tv = time.time()
                self._log_images(writer, batch, step_idx + 1)
                overhead += time.time() - tv
            if (step_idx + 1) % cfg.save_freq == 0:
                tv = time.time()
                self.save(step_idx + 1)
                overhead += time.time() - tv

    def _log_images(self, writer, batch: dict, step: int) -> None:
        """The image panels (utils/vis.train_panels) of the device batch's
        first two frames, one video's, from forward_vis with draws seeded
        by `step`, through writer.add_image; and the mean mesh as
        <run>/<step>-iter-mean-mesh.obj (selfcorr_tpu/train/loop.py
        :364-469). A failure raises: the JAX package prints it and trains
        on (ROADMAP C.10), which would hide a failed kernel launch."""
        sub = decompress_batch({k: batch[k][:2] for k in BATCH_KEYS})
        v = forward_vis(self.state.model, self.state.dino, sub,
                        self.constants, self.cfg,
                        generator=torch.Generator().manual_seed(step))
        host = {k: x.cpu().numpy() for k, x in sub.items()}
        products = {k: x.cpu().numpy() for k, x in v.items()}
        for tag, panel in train_panels(host, products, self.cfg).items():
            writer.add_image(tag, panel, step, dataformats="HWC")
        save_obj(os.path.join(self.run_dir, f"{step}-iter-mean-mesh.obj"),
                 self.state.model.mesh.mean_v.detach().cpu().numpy(),
                 self.constants.faces)


def main(argv) -> Trainer:
    """argv[0] is the program name, as in sys.argv."""
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(argv[1:])
    resolve_device(cfg.device)
    trainer = Trainer(cfg)
    trainer.train()
    return trainer
