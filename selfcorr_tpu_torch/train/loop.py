"""Training loop and the entry point (counterpart of
selfcorr_tpu/train/loop.py Trainer.train):

  python -m selfcorr_tpu_torch.train --flagfile config/wild6d/laptop.txt \
      --dataset_path <Wild6D>/laptop --train_list <list> \
      [--checkpoint_dir log --name exp] [--save_freq 2000] [--device cpu] \
      [--dino_bf16] [--synthetic_on_device [--steps_per_dispatch K]] \
      [--profile_steps N] \
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
the dataset's sample stream afresh. With --synthetic_on_device,
--dataset_name synthetic and one rank (where the JAX package takes its
device path), the batches are made on the device instead
(data/synthetic_device.py, float32, no loader and no upload), each from
draws seeded by (seed + 2, step); --steps_per_dispatch K then runs up to K
steps between the boundary checks, the chunks clipped at the log, vis and
save steps, bit for bit the run of K = 1 and logged at the same steps (the
JAX package's K-step scan also logs the last step). K is ignored on the
loader's path and under --profile_steps, as in the JAX package.
--profile_steps N traces steps 11 to 10 + N with torch.profiler (CPU and
CUDA activities) into <run>/trace/ as a Chrome trace, on rank 0; a run
that ends inside the window writes the steps it traced. The program's
spans (utils/tracing.py) are on for those steps, so the trace holds them
as ranges over the device's operations, and the loop prints them as a
table (calls, host, device and self host ms a step) with the five spans
under which the device idled longest. Every
batch_log_interval steps the
metrics are fetched in one transfer, logged and printed; last_logged_loss
keeps the total loss of the last log. A checkpoint is written every
save_freq steps and at the end; every vis_freq steps the image panels of
the step's first two frames go to the writer (add_image) and the mean
mesh to <run>/<step>-iter-mean-mesh.obj (_log_images); the time of both is
left out of the printed rate.
"""
from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.loader import (BATCH_KEYS, TrainLoader,
                                            compress_batch_host)
from selfcorr_tpu_torch.models.meshnet import (build_mesh_constants,
                                               draw_step, forward_vis)
from selfcorr_tpu_torch.ops.mesh_ops import save_obj
from selfcorr_tpu_torch import parallel as P
from selfcorr_tpu_torch.train.step import (decompress_batch, init_state,
                                           train_step)
from selfcorr_tpu_torch.utils import checkpoint as ckpt
from selfcorr_tpu_torch.utils import tracing
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
        self.chunks = []                # steps run between boundary checks
        self.trace_path = None          # the profiler trace, once written

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

    def device_batches(self) -> bool:
        """Whether this run's batches are made on the device: where the
        JAX package makes them there (selfcorr_tpu/train/loop.py:122-124),
        --synthetic_on_device on the synthetic videos with one rank."""
        cfg = self.cfg
        return (cfg.synthetic_on_device and cfg.dataset_name == "synthetic"
                and self.world == 1)

    def train(self):
        cfg = self.cfg
        start = self.state.step
        writer = make_writer(self.run_dir) if self.is_main else NoopWriter()
        self.log(f"[train] scalars go to {type(writer).__name__} in "
                 f"{self.run_dir}")
        loader = None
        if self.device_batches():
            from selfcorr_tpu_torch.data import synthetic_device as SD
            gen = SD.make_device_synth(cfg, make_train_dataset(cfg).videos,
                                       self.device)
            self.log(f"[train] batches are made on the device "
                     f"(--synthetic_on_device), up to "
                     f"{cfg.steps_per_dispatch} steps between boundary "
                     f"checks")

            def next_batch(step):
                return gen(SD.step_generator(cfg.seed, step))
        else:
            if cfg.synthetic_on_device:
                self.log(f"[train] --synthetic_on_device needs "
                         f"--dataset_name synthetic and one rank; batches "
                         f"come from the loader")
            rows = self.world * cfg.batch_size * cfg.repeat
            loader = TrainLoader(make_train_dataset(cfg, self.world), cfg,
                                 start=start,
                                 host_transform=(compress_batch_host
                                                 if cfg.compact_transfer
                                                 else None),
                                 row_range=P.process_row_range(
                                     self.rank, self.world, rows))
            it = iter(loader)

            def next_batch(step):
                return self.upload(next(it))
        try:
            self._loop(next_batch, writer, start)
        finally:
            if loader is not None:
                loader.close()
            writer.close()
        P.barrier()     # every rank reads the directory before rank 0 writes
        if ckpt.latest_step(self.ckpt_dir) != self.state.step:
            self.save(self.state.step)

    def chunk(self, step: int) -> int:
        """How many steps run from `step` before the next boundary check:
        up to --steps_per_dispatch on the device path without the profiler,
        clipped at the next log, vis or save step and at the end; else 1."""
        cfg = self.cfg
        if (not self.device_batches() or cfg.steps_per_dispatch <= 1
                or cfg.profile_steps > 0):
            return 1
        ends = [cfg.total_iters] + [
            (step // f + 1) * f for f in (cfg.batch_log_interval,
                                          cfg.vis_freq, cfg.save_freq)
            if f > 0]
        return min(cfg.steps_per_dispatch, min(ends) - step)

    def _loop(self, next_batch, writer, start: int):
        cfg = self.cfg
        t0 = time.time()
        overhead = 0.0      # vis and save time since the last log, not in
                            # the rate
        prof = None
        step = start
        while step < cfg.total_iters:
            k = self.chunk(step)
            self.chunks.append(k)
            for _ in range(k):
                batch = next_batch(step)
                b = batch["img"].shape[0]
                draws = draw_step(step_generator(cfg.seed, step, self.rank),
                                  cfg, b)
                metrics = train_step(self.state, batch, draws, cfg,
                                     self.group)
                if cfg.profile_steps > 0 and self.is_main:
                    prof = self._profile(prof, step)
                step += 1
            if self.is_main and step % cfg.batch_log_interval == 0:
                names = sorted(metrics)
                packed = torch.stack([metrics[n].float().reshape(())
                                      for n in names]).cpu().tolist()
                vals = dict(zip(names, packed))
                self.logged.append((step, vals))
                self.last_logged_loss = vals["total_loss"]
                log_metrics(writer, vals, step - 1)
                dt = (time.time() - t0 - overhead) / cfg.batch_log_interval
                print(f"iter {step}/{cfg.total_iters} "
                      f"loss {vals['total_loss']:.4f} {dt * 1000:.0f} "
                      f"ms/iter ({b * self.world / dt:.1f} imgs/s)",
                      flush=True)
                t0 = time.time()
                overhead = 0.0
            if self.is_main and step % cfg.vis_freq == 0:
                tv = time.time()
                self._log_images(writer, batch, step)
                overhead += time.time() - tv
            if step % cfg.save_freq == 0:
                tv = time.time()
                self.save(step)
                overhead += time.time() - tv
        if prof is not None:
            self._stop_profile(prof, step - 1, ended=True)
        if cfg.profile_steps > 0 and self.is_main and self.trace_path is None:
            print(f"[profile] no trace written: the run took steps {start} "
                  f"to {step - 1}, and the trace starts after step 10",
                  flush=True)

    def _profile(self, prof, step_idx: int):
        """torch.profiler over the steps (0-based, as the log's step - 1)
        11 to 10 + N: started after step 10, stopped after step 10 + N, as
        the JAX package's jax.profiler trace (selfcorr_tpu/train/loop.py:
        250-255). Called after each step; returns the running profiler or
        None."""
        n = self.cfg.profile_steps
        if step_idx == 10:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            self._tracing = (tracing.enable(), tracing.opened())
            prof.start()
        elif prof is not None and step_idx == 10 + n:
            self._stop_profile(prof, step_idx, ended=False)
            prof = None
        return prof

    def _stop_profile(self, prof, last: int, ended: bool) -> None:
        """Synchronize, stop and write <run>/trace/steps_11-<last>.json;
        print the program's spans over the traced steps and the device's
        longest idle totals by span, and put the tracer back as it was."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        was_on, since = self._tracing
        if not was_on:
            tracing.disable()
        trace_dir = os.path.join(self.run_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"steps_11-{last}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
        print(f"profiler trace of steps 11 to {last} written to {path}"
              + (f" (the run ended inside the window, which runs to "
                 f"{10 + self.cfg.profile_steps})" if ended else ""),
              flush=True)
        rec = tracing.read(since)
        steps = max(len(rec["units"]), 1)
        print("\n".join(tracing.table(rec)), flush=True)
        idle = sorted(tracing.idle_by_span(prof.events()).items(),
                      key=lambda kv: -kv[1])[:5]
        print("[profile] device idle by innermost span, ms a step: "
              + (", ".join(f"{k} {v / steps:.2f}" for k, v in idle)
                 if idle else "no device operation in the trace"),
              flush=True)

    def _log_images(self, writer, batch: dict, step: int) -> None:
        """The image panels (utils/vis.train_panels) of the device batch's
        first two frames, one video's, from forward_vis with draws seeded
        by `step`, through writer.add_image (a bf16 trunk runs as an f32
        copy of its rounded weights); and the mean mesh as
        <run>/<step>-iter-mean-mesh.obj (selfcorr_tpu/train/loop.py
        :364-469). A failure raises: the JAX package prints it and trains
        on (ROADMAP C.10), which would hide a failed kernel launch."""
        sub = decompress_batch({k: batch[k][:2] for k in BATCH_KEYS})
        dino = self.state.dino
        if dino.dtype != torch.float32:
            # --dino_bf16: the JAX package applies the bf16 weights to the
            # f32 images, so every layer computes in f32
            dino = copy.deepcopy(dino).float()
        v = forward_vis(self.state.model, dino, sub, self.constants,
                        self.cfg,
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
