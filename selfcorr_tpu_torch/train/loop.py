"""Training loop and the entry point (counterpart of
selfcorr_tpu/train/loop.py Trainer.train):

  python -m selfcorr_tpu_torch.train --flagfile config/wild6d/laptop.txt \
      --dataset_path <Wild6D>/laptop --train_list <list> \
      [--checkpoint_dir log --name exp] [--save_freq 2000] [--device cpu] \
      [--num_devices N [--num_processes P --process_id i \
       --coordinator_address host:port | --multihost]]

The data is Wild6D, NOCS, CUB or the synthetic videos (--dataset_name).
Several devices train data parallel (parallel/): --batch_size
counts videos per device, so a step takes N x batch_size x repeat rows,
which every rank draws as one plan of N shard-major blocks and of which it
decodes its own; each rank's draws come from its own generator
(step_generator), and rank 0 alone writes the config snapshot, the scalar
and image logs, the prints and the checkpoints.

Runs on CUDA unless --device cpu is given; a missing GPU is an error. The
run's directory is checkpoint_dir/name: config.txt (every flag), the scalar
log (TensorBoard when it is installed) and ckpt/<step>/ (utils/checkpoint).
A Trainer over a directory that holds a checkpoint resumes from its latest
step (every rank reads it). Each step draws from a generator seeded by
(seed, step, rank), the counterpart of the JAX loop's
fold_in(PRNGKey(seed + 1), step) folded with the axis index. Batches come
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
from selfcorr_tpu_torch import parallel as P
from selfcorr_tpu_torch.train.step import (decompress_batch, init_state,
                                           train_step)
from selfcorr_tpu_torch.utils import checkpoint as ckpt
from selfcorr_tpu_torch.utils.device import resolve_device, set_fp32_precision
from selfcorr_tpu_torch.utils.logging import (NoopWriter, log_metrics,
                                              make_writer,
                                              write_config_snapshot)
from selfcorr_tpu_torch.utils.vis import train_panels


def make_train_dataset(cfg: Config, num_shards: int = 1):
    """The training reader of cfg.dataset_name; its plans hold num_shards
    blocks of batch_size x repeat rows, one a rank."""
    if cfg.dataset_name == "Wild6D":
        from selfcorr_tpu_torch.data.wild6d import Wild6DTrain
        return Wild6DTrain(cfg, seed=cfg.seed, num_shards=num_shards)
    if cfg.dataset_name == "synthetic":
        from selfcorr_tpu_torch.data.synthetic import SyntheticTrain
        return SyntheticTrain(cfg, seed=cfg.seed, shape=cfg.synthetic_shape,
                              num_shards=num_shards)
    if cfg.dataset_name == "nocs":
        from selfcorr_tpu_torch.data.nocs import NOCSTrain
        return NOCSTrain(cfg, seed=cfg.seed, num_shards=num_shards)
    if cfg.dataset_name == "cub":
        from selfcorr_tpu_torch.data.cub import CUBTrain
        return CUBTrain(cfg, seed=cfg.seed, num_shards=num_shards)
    raise ValueError(f"unknown dataset {cfg.dataset_name!r}: Wild6D, "
                     f"synthetic, nocs or cub")


def step_generator(seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The draws of step `step` of a run seeded `seed`, on rank `rank`:
    rank 0's stream is the one-device run's, every other rank's its own."""
    if rank == 0:
        return torch.Generator().manual_seed((seed + 1) * 1_000_003 + step)
    key = np.random.SeedSequence((seed, step, rank)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


class Trainer:
    """The training loop of one rank, or of the one process when `rank` is
    None (parallel.launch gives the ranks)."""

    def __init__(self, cfg: Config, rank: P.Rank | None = None):
        refuse_unported(cfg, train=True)
        P.require_rank(cfg, rank)
        self.cfg = cfg
        self.rank = rank.rank if rank else 0
        self.world = rank.world if rank else 1
        self.group = rank.group if rank else None
        self.is_main = P.is_main()
        self.device = rank.device if rank else resolve_device(cfg.device)
        set_fp32_precision()
        self.run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")
        if self.is_main:
            write_config_snapshot(self.run_dir, cfg)
        self.constants = build_mesh_constants(cfg)
        self.state = init_state(cfg, self.constants, self.device)
        start = ckpt.latest_step(self.ckpt_dir)
        if start is not None:
            self.log(f"resuming from checkpoint step {start}")
            ckpt.restore_state(self.ckpt_dir, self.state, start)
        if self.group is not None:
            P.broadcast_module(self.state.model, group=self.group)
            P.broadcast_module(self.state.dino, group=self.group)
        self.last_logged_loss = None    # total_loss at the last log step
        self.logged = []                # (step, {metric: value}) per log

    def log(self, msg: str) -> None:
        """Print on rank 0."""
        if self.is_main:
            print(msg, flush=True)

    def upload(self, batch: dict) -> dict:
        out = {}
        for k in BATCH_KEYS:
            t = torch.as_tensor(np.ascontiguousarray(batch[k]))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def save(self, step: int) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.is_main:
            path = ckpt.save_state(self.ckpt_dir, self.state, step)
            self.log(f"saved checkpoint at step {step} ({path})")
        P.barrier()

    def train(self):
        cfg = self.cfg
        start = self.state.step
        writer = make_writer(self.run_dir) if self.is_main else NoopWriter()
        self.log(f"[train] scalars go to {type(writer).__name__} in "
                 f"{self.run_dir}")
        rows = self.world * cfg.batch_size * cfg.repeat
        loader = TrainLoader(make_train_dataset(cfg, self.world), cfg,
                             start=start,
                             host_transform=(compress_batch_host
                                             if cfg.compact_transfer
                                             else None),
                             row_range=P.process_row_range(
                                 self.rank, self.world, rows))
        try:
            self._loop(loader, writer, start)
        finally:
            loader.close()
            writer.close()
        P.barrier()     # every rank reads the directory before rank 0 writes
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
            draws = draw_step(step_generator(cfg.seed, step_idx, self.rank),
                              cfg, b)
            metrics = train_step(self.state, batch, draws, cfg, self.group)
            if self.is_main and (step_idx + 1) % cfg.batch_log_interval == 0:
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
                      f"ms/iter ({b * self.world / dt:.1f} imgs/s)",
                      flush=True)
                t0 = time.time()
                overhead = 0.0
            if self.is_main and (step_idx + 1) % cfg.vis_freq == 0:
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


def _train(rank: P.Rank | None, cfg: Config) -> Trainer:
    trainer = Trainer(cfg, rank)
    trainer.train()
    return trainer


def main(argv) -> Trainer | None:
    """argv[0] is the program name, as in sys.argv. Trains in this process
    and returns its Trainer, or in spawned local ranks (parallel.launch)
    and returns None."""
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(argv[1:])
    resolve_device(cfg.device)
    return P.launch(_train, cfg, cfg)
