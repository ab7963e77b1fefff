"""Data parallelism over torch.distributed: one process (a rank) per device
(counterpart of selfcorr_tpu/parallel/sharding.py and of the JAX package's
shard_map train step, selfcorr_tpu/train/step.py train_step_sharded).

Parameters and optimizer state are replicated: every rank builds them from
the same seed and files, and rank 0's are broadcast after that
(broadcast_module). Each rank decodes its own rows of the global batch
(process_row_range), runs the forward and backward on them with its own
draws, and the ranks then average the gradients, the aux losses and the
BatchNorm running statistics (all_mean_) before every rank clips and takes
the same AdamW step: the JAX step's pmean. BatchNorm normalises with each
rank's own batch statistics, as under shard_map (not SyncBatchNorm).

The flags keep the JAX package's meaning (configs.check_parallel_flags):
  --num_devices N     the global device count, hence the world size. With
                      no multi-process flag, N > 1 starts N local ranks on
                      cuda:0 .. N-1 (or N CPU ranks with --device cpu) that
                      meet at a free localhost port.
  --num_processes P --process_id i --coordinator_address host:port
                      process i of P starts N / P local ranks; their global
                      ranks are i * N / P + local.
  --multihost         alone: the cluster comes from torchrun's environment
                      (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
                      MASTER_PORT; env://), one rank per process.
At --num_devices 1 with no multi-process flag nothing is initialised and
the entry points run in their own process, as the JAX Trainer keeps
mesh = None. The backend is NCCL for CUDA ranks and gloo for CPU ranks;
run_ranks' `backend` puts gloo on a card (two ranks on one GPU, which NCCL
refuses). A missing NCCL, more local ranks than GPUs, or torchrun's
variables absent under --multihost raise; nothing falls back.

Local ranks are spawn-started (torch.multiprocessing.start_processes, join):
the first rank to raise ends the run and the others are terminated, and a
rank on another host that waits in a collective gives up after the group's
timeout. A spawned rank re-imports the entry point's module, so start them
from a module or a file.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass, replace
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from selfcorr_tpu_torch.configs import Config, check_parallel_flags

DEFAULT_TIMEOUT = timedelta(minutes=10)
_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Layout:
    """The ranks of a run as this process sees them."""
    world: int                  # ranks in all
    first: int                  # global rank of this process's first rank
    devices: tuple              # the device of each rank this process runs
    init_method: str = ""       # tcp://host:port or env://; "" = a free
                                # localhost port, chosen at launch
    backend: str = ""           # "" = NCCL on CUDA, gloo on the CPU


@dataclass(frozen=True)
class Rank:
    """One rank, as the entry points' Trainer and Tester take it."""
    rank: int
    world: int
    device: torch.device
    group: object               # the default process group


def layout(cfg: Config) -> Layout | None:
    """The ranks cfg asks for, or None for one process without a group.
    Raises ValueError on flags that do not hold together, on more local
    CUDA ranks than this machine's GPUs, and RuntimeError for --multihost
    without torchrun's variables."""
    check_parallel_flags(cfg)
    kind = torch.device(cfg.device).type
    first_local = 0
    if cfg.num_processes:
        per = cfg.num_devices // cfg.num_processes
        lay = Layout(cfg.num_devices, cfg.process_id * per, (kind,) * per,
                     init_method=f"tcp://{cfg.coordinator_address}")
    elif cfg.multihost:
        missing = [k for k in _TORCHRUN if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--multihost alone takes the cluster from torchrun's "
                f"environment, and {', '.join(missing)} are not set: start "
                f"the entry point under torchrun, or give "
                f"--coordinator_address, --num_processes and --process_id")
        world = int(os.environ["WORLD_SIZE"])
        if cfg.num_devices not in (1, world):
            raise ValueError(f"--num_devices {cfg.num_devices} but "
                             f"torchrun's WORLD_SIZE is {world}")
        first_local = int(os.environ["LOCAL_RANK"])
        lay = Layout(world, int(os.environ["RANK"]), (kind,),
                     init_method="env://")
    elif cfg.num_devices > 1:
        lay = Layout(cfg.num_devices, 0, (kind,) * cfg.num_devices)
    else:
        return None
    if kind == "cuda":
        have = torch.cuda.device_count()
        if first_local + len(lay.devices) > have:
            raise ValueError(
                f"{len(lay.devices)} CUDA rank(s) from local rank "
                f"{first_local} asked for, but this machine has {have} "
                f"GPU(s): one rank per GPU")
        lay = replace(lay, devices=tuple(
            f"cuda:{first_local + i}" for i in range(len(lay.devices))))
    return lay


def require_rank(cfg: Config, rank: Rank | None) -> None:
    """Raise if cfg asks for ranks (layout) and the caller gives none: the
    ranks start through launch, which the entry points' main calls."""
    if rank is None and (lay := layout(cfg)) is not None:
        raise ValueError(
            f"the flags ask for {lay.world} rank(s) with a process group: "
            f"start them through parallel.launch (the train and predict "
            f"entry points' main does)")


def init_distributed(rank: int, world: int, coordinator: str,
                     device="cuda", backend: str | None = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the default process group as `rank` of `world`. `coordinator`
    is host:port or an init URL (tcp://host:port, env://). The backend is
    NCCL for a CUDA device and gloo for the CPU unless `backend` names one;
    NCCL missing on a CUDA device raises. Collectives that wait longer than
    `timeout` fail."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this PyTorch build, "
                           "and CUDA ranks communicate over NCCL")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=world, timeout=timeout)


def process_row_range(rank: int, world: int,
                      global_rows: int) -> tuple[int, int]:
    """[start, stop) of the global batch's rows that `rank` owns: equal
    contiguous blocks in rank order (the JAX package's P('data'))."""
    if global_rows % world:
        raise ValueError(f"{global_rows} rows do not split over {world} "
                         f"ranks")
    per = global_rows // world
    return rank * per, (rank + 1) * per


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(index: int, lay: Layout, fn: Callable, args: tuple,
               spawned: bool):
    device = torch.device(lay.devices[index])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif spawned:      # the host's cores, shared among its CPU ranks
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // len(lay.devices)))
    rank = lay.first + index
    init_distributed(rank, lay.world, lay.init_method, device,
                     lay.backend or None)
    try:
        return fn(Rank(rank, lay.world, device, dist.group.WORLD), *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, lay: Layout, *args):
    """fn(rank: Rank, *args) in every rank of `lay` that this process
    runs: in this process when it runs one (fn's result is returned), else
    in as many spawn-started processes, joined (None is returned; the
    first rank to raise ends them all and its error is raised here). fn
    and args must pickle."""
    if not lay.init_method:
        lay = replace(lay, init_method=f"tcp://127.0.0.1:{free_port()}")
    if len(lay.devices) == 1:
        return _rank_main(0, lay, fn, args, False)
    mp.start_processes(_rank_main, args=(lay, fn, args, True),
                       nprocs=len(lay.devices), join=True,
                       start_method="spawn")
    return None


def launch(fn: Callable, cfg: Config, *args):
    """fn(rank, *args) in the ranks cfg asks for (layout), or fn(None,
    *args) in this process when it asks for none. Returns fn's result when
    it ran in this process, else None."""
    lay = layout(cfg)
    if lay is None:
        return fn(None, *args)
    return run_ranks(fn, lay, *args)


def is_main() -> bool:
    """True in rank 0, and in a process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _coalesced_(tensors: Sequence[torch.Tensor], group, op: Callable,
                divisor: int = 1) -> None:
    """op(flat) on one flat buffer per dtype and device holding `tensors`,
    the buffer divided by `divisor`, then copied back into the tensors (a
    few multi-tensor launches, not one a tensor). gloo groups run op on a
    host copy of a CUDA buffer (by backend)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        host = dist.get_backend(group) == "gloo" and flat.is_cuda
        buf = flat.cpu() if host else flat
        op(buf)
        if host:
            flat.copy_(buf)
        if divisor != 1:
            flat /= divisor
        pieces = flat.split([t.numel() for t in ts])
        with torch.no_grad():
            torch._foreach_copy_(ts, [p.view_as(t)
                                      for p, t in zip(pieces, ts)])


def all_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace every tensor by its mean over the group's ranks, in place:
    one flat buffer and one all_reduce(SUM) per dtype, then a division by
    the world size."""
    _coalesced_(tensors, group, lambda b: dist.all_reduce(b, group=group),
                dist.get_world_size(group))


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """A copy of `t` summed over the group's ranks."""
    out = t.clone()
    _coalesced_([out], group, lambda b: dist.all_reduce(b, group=group))
    return out


def broadcast_module(module: torch.nn.Module, src: int = 0,
                     group=None) -> None:
    """Every parameter and buffer of `module` takes rank `src`'s values."""
    _coalesced_(list(module.parameters()) + list(module.buffers()), group,
                lambda b: dist.broadcast(b, src, group=group))


def gather_objects(obj, group=None) -> list:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
