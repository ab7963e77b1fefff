"""The control of the benchmark's comparison, and the faults that set the
upper readings of its limits (not run by the benchmark's runs).

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--mode tf32|half_batch|sum|no_exchange ...]
    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        --plant sum|bn_local|no_exchange|unchanged|half_batch [--seconds 2]

--mode makes the cell's weights and inputs as a run does, puts the
reference in the program's place on one card and reads the numbers a run
compares, one line for each mode; in a cell over several ranks (the
traffic's `ranks`) the reference steps over every rank's shard in turn
(benchmark/reference/train/step.py):
  tf32         the control: the reference in the nearest precision below
               the configurations' float32 (TF32 matmuls and convolutions);
  half_batch   a training fault: the reference stepping on half of each
               batch (the first half of each shard's videos), its losses
               the mean over those rows;
  sum          fault (a) of several ranks: the shards' sum in place of
               their mean;
  no_exchange  fault (c) of several ranks: rank 0's shard alone, its own
               gradients, losses and statistics with no exchange.
The other side is the reference as the configuration states it, taken
once a seed; a cell over several ranks has no replica_gap there.

--plant runs a cell over several ranks on its cards (benchmark/harness/
train_dp.py) with the program broken in every rank: sum (a), bn_local (b:
the BatchNorm running statistics left out of the exchange), no_exchange
(c), unchanged (the optimizer's step skipped: the state stays as it was)
and half_batch (each rank steps on the first half of its videos, its
losses the mean over those rows); it prints the numbers the run compares.

Prints one JSON line a seed and mode with the numbers and the cell's
limits."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import common, compare, inputs  # noqa: E402
from benchmark.harness import weights as W  # noqa: E402
from benchmark.harness.cell import resolve  # noqa: E402
from benchmark.harness.train_dp import rank_seed  # noqa: E402


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def train_side(cell, rcfg, seed: int, device, mode: str | None) -> tuple:
    """(each checked step's loss terms, the first gradients, the changes
    over the checked steps) of the reference from the cell's weights and
    first batches, as `mode` breaks it (tf32 and None: as stated)."""
    from benchmark.reference.models.meshnet import (StepDraws,
                                                    build_mesh_constants,
                                                    device_constants)
    from benchmark.reference.train.optim import Optimizer
    from benchmark.reference.train.step import train_step
    tr = cell.traffic
    world = tr.get("ranks", 1)
    rconst = build_mesh_constants(rcfg)
    model, dino = W.reference_modules(rcfg, rconst, seed, device)
    model.train()
    dino.eval().requires_grad_(False)
    b = rcfg.batch_size * rcfg.repeat
    pool = inputs.train_pool(tr["pool_batches"], rcfg.batch_size * world,
                             rcfg.repeat, tr["videos"],
                             tr["frames_per_video"], rcfg.img_size, seed,
                             device)
    chamfer = rcfg.use_depth and rcfg.depth_loss_chamfer
    half = mode == "half_batch"
    cfg = rcfg.replace(batch_size=rcfg.batch_size // 2) if half else rcfg
    rows = cfg.batch_size * cfg.repeat
    opt = Optimizer(model, cfg)
    names = [n for g in opt.groups.values() for n, _ in g]
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    dc = device_constants(rconst, device)
    # the runners' draws: the seed's on one card, each rank's own on several
    seeds = [seed] if world == 1 else [rank_seed(seed, r)
                                       for r in range(world)]
    ranks = range(1) if mode == "no_exchange" else range(world)
    aux_steps, first = [], None
    for i in range(tr["check_steps"]):
        shards = []
        for r in ranks:
            d = inputs.step_draws(seeds[r], i, b, rcfg.symmetry_npts,
                                  chamfer)
            shards.append((
                {k: v[r * b:r * b + rows] for k, v in pool[i].items()},
                StepDraws(**{k: (v[:rows] if v is not None and v.dim() == 3
                                 else v) for k, v in d.items()})))
        aux, grads = train_step(model, dino, opt, dc, shards, cfg, i,
                                world=1 if mode == "sum" else len(shards))
        aux_steps.append({k: float(v) for k, v in aux.items()})
        if i == 0:
            first = {n: grads[n] for n in names}
        del grads
    change = {n: p.detach() - p0[n] for n, p in model.named_parameters()
              if n in first}
    return aux_steps, first, change


def predict_side(cell, rcfg, seed: int, device) -> list:
    from benchmark.reference.eval.predict import predict_batch
    from benchmark.reference.models.meshnet import build_mesh_constants
    tr = cell.traffic
    rconst = build_mesh_constants(rcfg)
    model, _ = W.reference_modules(rcfg, rconst, seed, device)
    model.eval()
    pool = inputs.test_pool(tr["pool_batches"], tr["batch"], tr["videos"],
                            tr["frames_per_video"], rcfg.img_size, seed,
                            device)
    out = []
    for j, batch in enumerate(pool):
        jitter, rseed = inputs.predict_draws(seed, j)
        fit = predict_batch(model, rconst, rcfg, batch, jitter, rseed,
                            device)
        out.append({k: fit[k].cpu() for k in ("rotation", "translation",
                                              "bbox9", "ok")})
    return out


def numbers(cell, seed: int, modes: list, device,
            flag_overrides=None) -> dict:
    """{mode: the numbers of the reference broken by the mode against the
    reference as stated}, the sound side taken once."""
    rcfg = common.reference_config(common.flag_values(cell, flag_overrides))
    train = cell.traffic["entry"] != "predict_batch"
    sides = {}
    for mode in [None, *modes]:
        _tf32(mode == "tf32")
        sides[mode] = (train_side(cell, rcfg, seed, device, mode) if train
                       else predict_side(cell, rcfg, seed, device))
        common.free(device)
    _tf32(False)
    sound = sides.pop(None)
    if train:
        lr, gr, cr = sound
        return {mode: compare.train_numbers(lp, lr, gp, gr, cp, cr)[0]
                for mode, (lp, gp, cp) in sides.items()}
    out = {}
    for mode, got in sides.items():
        out[mode] = {}
        for g, r in zip(got, sound):
            out[mode] = compare.merge_worst(out[mode],
                                            compare.predict_numbers(g, r))
    return out


def plant_sum():
    """Fault (a): the ranks' sum in place of their mean."""
    import torch.distributed as dist

    import selfcorr_tpu_torch.train.step as step_mod
    from selfcorr_tpu_torch import parallel as P
    step_mod.all_mean_ = lambda tensors, group=None: P._coalesced_(
        tensors, group, lambda buf: dist.all_reduce(buf, group=group))


def plant_bn_local():
    """Fault (b): the BatchNorm running statistics left out of the
    exchange."""
    import selfcorr_tpu_torch.train.step as step_mod
    step_mod.running_stats = lambda model: []


def plant_no_exchange():
    """Fault (c): no exchange; every rank steps on its own gradients."""
    import selfcorr_tpu_torch.train.step as step_mod
    step_mod.all_mean_ = lambda tensors, group=None: None


def plant_unchanged():
    """A step that leaves its state unchanged: no optimizer update."""
    from selfcorr_tpu_torch.train import optim
    optim.Optimizer.step = lambda self, count: None


def plant_half_batch():
    """Half of each rank's batch left out, the mean taken over the rest:
    the step sees the first half of its videos."""
    import selfcorr_tpu_torch.train.step as step_mod
    real = step_mod.train_step

    def half(state, batch, draws, cfg, group=None):
        rows = batch["img"].shape[0] // 2
        cut = {k: v[:rows] for k, v in batch.items()}
        d = draws._replace(**{k: getattr(draws, k)[:rows]
                              for k in ("sym_u", "sym_ub")})
        return real(state, cut, d, cfg.replace(
            batch_size=cfg.batch_size // 2), group)
    step_mod.train_step = half


PLANTS = {"sum": plant_sum, "bn_local": plant_bn_local,
          "no_exchange": plant_no_exchange, "unchanged": plant_unchanged,
          "half_batch": plant_half_batch}


def planted(cell, seed: int, plant: str, seconds: float, device,
            flag_overrides=None) -> dict:
    """The numbers of a run of the cell with the program broken by
    `plant` in every rank."""
    from benchmark.harness import train_dp
    out = train_dp.run(cell, seed, seconds, False, device,
                       time.perf_counter(), {}, flag_overrides,
                       plant=PLANTS[plant])
    return out.numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    how = p.add_mutually_exclusive_group()
    how.add_argument("--mode", nargs="+",
                     choices=("tf32", "half_batch", "sum", "no_exchange"))
    how.add_argument("--plant", choices=sorted(PLANTS))
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = resolve(args.workload)
    modes = args.mode or ([] if args.plant else ["tf32"])
    several = cell.traffic.get("ranks", 1) > 1
    if not several and (args.plant or {"sum", "no_exchange"} & set(modes)):
        p.error(f"{args.workload} runs on one rank: no exchange to break")
    need = cell.chips if args.plant else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this runs on {need} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _tf32(False)
    for seed in args.seeds:
        t = time.perf_counter()
        got = (numbers(cell, seed, modes, device) if modes else
               {f"plant {args.plant}": planted(cell, seed, args.plant,
                                               args.seconds, device)})
        for mode, nums in got.items():
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, "numbers": nums,
                              "limits": cell.limits,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
