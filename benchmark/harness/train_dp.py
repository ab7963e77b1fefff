"""The runner of the `train_step_dp` traffic: the program's training step
across ranks, data parallel, started as the training entry point starts
them (parallel.layout of the configuration at --num_devices N, then
parallel.run_ranks: spawn-started processes, one a device, NCCL between
CUDA ranks and gloo between CPU ranks).

Every rank makes the benchmark's weights and the pool of distinct global
batches from the seed, keeps its own rows of each (process_row_range),
takes its own per-step draws (the seed's words with its rank) and builds
the program's state, which then takes rank 0's values (broadcast_module,
as the Trainer does). Set-up drives the first steps through the window's
own call, train_step with the group; the first `check_steps` are the ones
the reference follows. The window's step count is fixed before it opens,
from the last warm-up steps' time, and rank 0 broadcasts it, so the window
adds no collective to the steps' own: it opens after a barrier, runs the
steps back to back, and closes with a synchronize and a barrier on every
rank. Its rate is the global images of every step over rank 0's window
seconds.

After the window every rank reads its peak memory, rank 0 compares every
rank's parameters and buffers with its own (replica_gap), and the program
is freed. The ranks then take the reference's step (benchmark/reference/
train/step.py) from the same weights, rows and draws, each on its own
shard, the shards summed by torch.distributed.all_reduce, and only then
report the modules they hold, so that whatever any phase of a rank loaded
is seen by run.py's look for JAX. In a traced run every rank loads the
readers, so each runs with the program's tracer and the outside spans as
rank 0 does; rank 0 alone profiles and reads the per-layer metrics. It
hands its result to the launching process through a file in the temporary
directory."""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from types import SimpleNamespace

import torch

from benchmark.harness import common, inputs
from benchmark.harness import trace as T
from benchmark.harness import weights as W
from benchmark.harness.train import _program_state, capture, follow

RANK_SALT = 6


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s per-step draws."""
    return inputs.seed_words(seed, RANK_SALT, rank)


def _barrier(device) -> None:
    import torch.distributed as dist
    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def _smi(*args) -> str | None:
    """nvidia-smi's output, or None where it does not run or refuses."""
    try:
        got = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    text = got.stdout.strip()
    return text if got.returncode == 0 and "Failed" not in text else None


def _topology() -> str:
    """How the cards are joined: nvidia-smi's topology matrix or, where
    the machine refuses it, its NVLink peer-to-peer matrix and card 0's
    links."""
    matrix = _smi("topo", "-m")
    if matrix:
        return "interconnect (nvidia-smi topo -m):\n" + matrix
    p2p = _smi("topo", "-p2p", "n") or "(refused)"
    links = [line.split(":", 1)[1].strip()
             for line in (_smi("nvlink", "--status", "-i", "0") or "")
             .splitlines() if line.strip().startswith("Link")]
    return ("interconnect: nvidia-smi topo -m refused; NVLink peer to peer "
            "(nvidia-smi topo -p2p n):\n" + p2p.split("Legend")[0].rstrip()
            + f"\ncard 0's NVLink links: {len(links)}, "
            f"{sorted(set(links))}")


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        readers: dict, flag_overrides: dict | None = None,
        plant=None) -> SimpleNamespace:
    """Start the cell's ranks and return rank 0's result. `plant`, a
    picklable callable that each rank calls first, breaks the program for
    the tests of the comparison; the benchmark passes none."""
    from selfcorr_tpu_torch import parallel as P
    flags = common.flag_values(cell, flag_overrides)
    flags["num_devices"] = cell.traffic["ranks"]
    lay = P.layout(common.program_config(flags))
    fd, path = tempfile.mkstemp(prefix="bench_dp_", suffix=".json")
    os.close(fd)
    job = SimpleNamespace(cell=cell, seed=seed, seconds=seconds,
                          trace=trace, t0=t0, readers=sorted(readers),
                          flags=flags, path=path, plant=plant)
    try:
        P.run_ranks(_rank, lay, job)
        with open(path) as f:
            out = SimpleNamespace(**json.load(f))
    finally:
        os.remove(path)
    if device.type == "cuda":
        out.notes.append(_topology())
    return out


def _rank(rank, job) -> None:
    """One rank's run (parallel.run_ranks calls it in each process)."""
    import torch.distributed as dist
    # one host thread for PyTorch's CPU operations, as in every run
    torch.set_num_threads(1)
    device = rank.device
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if job.plant is not None:
        job.plant()
    main = rank.rank == 0
    cell, seed, tr = job.cell, job.seed, job.cell.traffic
    # perf_counter is the system's monotonic clock, so the launching
    # process's start stays the start of set-up here
    clock = common.SetupClock(job.t0)
    # every rank loads the readers of a traced run, so that each runs its
    # steps with the same tracer and spans as rank 0, which alone reads
    from benchmark.harness.cell import metric_reader
    readers = ({n: metric_reader(n) for n in job.readers}
               if job.trace else {})
    import selfcorr_tpu_torch.train.step as step_mod
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch.models.meshnet import StepDraws
    pcfg = common.program_config(job.flags)
    rcfg = common.reference_config(job.flags)
    clock.mark("launch", device)
    if device.type == "cuda":
        torch.zeros((), device=device)
    clock.mark("cuda_init", device)
    _barrier(device)
    clock.mark("group_init", device)
    if device.type == "cuda":
        from selfcorr_tpu_torch.ops import attention
        from selfcorr_tpu_torch.ops.rasterizer import kernel
        if not main:            # rank 0 builds what is not built yet
            _barrier(device)
        kernel.build()
        attention.build()
        if main:
            _barrier(device)
    clock.mark("kernel_load", device)

    from benchmark.reference.models.meshnet import build_mesh_constants
    rconst = build_mesh_constants(rcfg)
    ref_model, ref_dino = W.reference_modules(rcfg, rconst, seed, device)
    clock.mark("weights", device)
    state = _program_state(pcfg, (ref_model.state_dict(),
                                  ref_dino.state_dict()), device)
    P.broadcast_module(state.model, group=rank.group)
    P.broadcast_module(state.dino, group=rank.group)
    p0 = ({n: p.detach().clone() for n, p in ref_model.named_parameters()}
          if main else None)
    clock.mark("program_state", device)

    b = rcfg.batch_size * rcfg.repeat
    lo, hi = P.process_row_range(rank.rank, rank.world, b * rank.world)
    pool = [{k: v[lo:hi].clone() for k, v in batch.items()}
            for batch in inputs.train_pool(
                tr["pool_batches"], rcfg.batch_size * rank.world,
                rcfg.repeat, tr["videos"], tr["frames_per_video"],
                rcfg.img_size, seed, device)]
    chamfer = rcfg.use_depth and rcfg.depth_loss_chamfer
    mine = rank_seed(seed, rank.rank)
    draws = [inputs.step_draws(mine, i, b, rcfg.symmetry_npts, chamfer)
             for i in range(tr["pool_batches"])]
    common.free(device)
    clock.mark("inputs", device)

    n_pool = len(pool)
    before = common.launches()
    done = [0]
    bads = []

    def one_step():
        i = done[0] % n_pool
        m = step_mod.train_step(state, pool[i], StepDraws(**draws[i]), pcfg,
                                rank.group)
        bads.append(m["bad_grad"])
        done[0] += 1
        return m

    check = tr["check_steps"]
    prog = capture(state, one_step, check, keep=main)
    # the last warm-up steps set the window's step count
    timed = max(1, tr["warmup_steps"] - check)
    common.sync(device)
    t_est = time.perf_counter()
    for _ in range(timed):
        one_step()
    common.sync(device)
    per_step = (time.perf_counter() - t_est) / timed
    steps = torch.tensor([max(1, round(job.seconds / per_step))],
                         device=device)
    dist.broadcast(steps, 0)
    steps = int(steps)
    clock.mark("warmup", device)

    out = SimpleNamespace(setup_s=clock.total(),
                          setup_parts=dict(clock.parts), metrics={},
                          per_layer={}, breakdown=None, busy_s=None,
                          window_s=None, notes=[])
    spans = common.spans_for(readers) if readers else None
    if job.trace:
        from selfcorr_tpu_torch.utils import tracing
        opened = tracing.opened()
    with (spans.active() if spans else contextlib.nullcontext()):
        _barrier(device)
        start = time.perf_counter()
        for _ in range(steps):
            one_step()
        common.sync(device)
        _barrier(device)
        window = time.perf_counter() - start
    out.attempted = steps
    if not job.trace:
        for m in cell.end_to_end:
            if m["unit"] == "imgs/s":
                out.metrics[m["name"]] = steps * b * rank.world / window
    else:
        if main:        # the program's spans a step over the window
            out.notes.append("the window's steps:")
            out.notes += tracing.table(tracing.read(since=opened))
        l0, opened = common.launches(), tracing.opened()

        def profiled():
            for _ in range(tr["profile_steps"]):
                one_step()
            common.sync(device)
        if main:
            prof = T.profile(profiled)
            out.notes.append(common.trace_launches(prof, l0,
                                                   common.launches()))
            if prof is not None:
                out.notes.append("collectives in the profiled steps: " + str({
                    k: v[0] for k, v in prof.kernels.items()
                    if "nccl" in k.lower()}))
            out.notes.append("the profiled steps:")
            out.notes += tracing.table(tracing.read(since=opened))
        else:
            profiled()
    peak = common.memory_peak(device)
    failed = int(torch.stack(bads).sum())
    off, line = common.launches_off(before, common.launches(), done[0],
                                    tr["launches_per_unit"], device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    flat = torch.cat([t.detach().reshape(-1).double()
                      for t in state.model.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    gap = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    replica_gap = float(gap)
    del state, flat, ref
    common.free(device)

    # the reference, once the window has closed and the program is freed
    t_ref = time.perf_counter()
    got = follow(prog, p0, ref_model, ref_dino, rconst, rcfg, device,
                 [[(pool[i], draws[i])] for i in range(check)],
                 main and job.trace, rank.world, dist.all_reduce)
    # every rank's modules as they stand once its last phase has run
    from benchmark.run import forbidden_modules
    ranks = P.gather_objects(dict(rank=rank.rank, peak=peak, kind=kind,
                                  forbidden=forbidden_modules()),
                             rank.group)
    if not main:
        return
    numbers, lines, flops = got
    numbers["launches_off"] = off
    numbers["replica_gap"] = replica_gap
    out.numbers = numbers
    out.reference_s = time.perf_counter() - t_ref
    out.memory_peak = max(r["peak"] for r in ranks)
    out.failed = failed
    out.forbidden = sorted({m for r in ranks for m in r["forbidden"]})
    out.notes.append(line)
    out.notes.append("ranks: " + json.dumps(ranks))
    if device.type == "cuda":
        out.notes.append(f"NCCL {torch.cuda.nccl.version()}, torch "
                         f"{torch.__version__}, CUDA {torch.version.cuda}")
    out.notes.append(f"window: {steps} steps fixed from {per_step:.4f} s "
                     f"a warm-up step, {window:.3f} s")
    out.notes += lines
    out.notes.append("numbers: " + json.dumps(numbers))

    if job.trace:
        ctx = common.LayerContext(
            spans=spans.ms() if spans else {},
            captured=spans.captured if spans else {}, units=steps,
            span_s=window, trace=prof, flops=flops, cfg=rcfg)
        common.read_layers(readers, ctx, out)
    with open(job.path, "w") as f:
        json.dump(vars(out), f)
