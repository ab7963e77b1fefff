"""The control of the benchmark's comparison, and the planted faults that
set the upper readings of its limits (not run by the benchmark's runs).

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 \
        [--mode tf32|half_batch]

For each seed it makes the cell's weights and inputs as a run does, puts
the reference in the program's place and reads the numbers a run
compares:
  tf32        the control: the reference in the nearest precision below
              the configurations' float32 (TF32 matmuls and convolutions);
  half_batch  a training fault: the reference stepping on half of each
              batch (the first half of its videos), its losses the mean
              over those rows.
The other side is the reference as the configuration states it. Prints
one JSON line a seed with the numbers and the cell's limits."""
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


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def train_side(cell, rcfg, seed: int, device, half: bool) -> tuple:
    """(each checked step's loss terms, the first gradients, the changes
    over the checked steps) of the reference from the cell's weights and
    first batches."""
    from benchmark.reference.models.meshnet import (StepDraws,
                                                    build_mesh_constants,
                                                    device_constants)
    from benchmark.reference.train.optim import Optimizer
    from benchmark.reference.train.step import train_step
    tr = cell.traffic
    rconst = build_mesh_constants(rcfg)
    model, dino = W.reference_modules(rcfg, rconst, seed, device)
    model.train()
    dino.eval().requires_grad_(False)
    b = rcfg.batch_size * rcfg.repeat
    pool = inputs.train_pool(tr["pool_batches"], rcfg.batch_size,
                             rcfg.repeat, tr["videos"],
                             tr["frames_per_video"], rcfg.img_size, seed,
                             device)
    chamfer = rcfg.use_depth and rcfg.depth_loss_chamfer
    cfg = rcfg.replace(batch_size=rcfg.batch_size // 2) if half else rcfg
    rows = cfg.batch_size * cfg.repeat
    opt = Optimizer(model, cfg)
    names = [n for g in opt.groups.values() for n, _ in g]
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    dc = device_constants(rconst, device)
    aux_steps, first = [], None
    for i in range(tr["check_steps"]):
        d = inputs.step_draws(seed, i, b, rcfg.symmetry_npts, chamfer)
        d = {k: (v[:rows] if v is not None and v.dim() == 3 else v)
             for k, v in d.items()}
        batch = {k: v[:rows] for k, v in pool[i].items()}
        aux, grads = train_step(model, dino, opt, dc, batch, StepDraws(**d),
                                cfg, i)
        aux_steps.append({k: float(v) for k, v in aux.items()})
        if i == 0:
            first = {n: grads[n] for n in names}
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


def numbers(cell, seed: int, mode: str, device, flag_overrides=None) -> dict:
    rcfg = common.reference_config(common.flag_values(cell, flag_overrides))
    train = cell.traffic["entry"] == "train_step"
    sides = []
    for faulty in (True, False):
        _tf32(faulty and mode == "tf32")
        if train:
            sides.append(train_side(cell, rcfg, seed, device,
                                    half=faulty and mode == "half_batch"))
        else:
            sides.append(predict_side(cell, rcfg, seed, device))
        common.free(device)
    _tf32(False)
    if train:
        (lp, gp, cp), (lr, gr, cr) = sides
        return compare.train_numbers(lp, lr, gp, gr, cp, cr)[0]
    out = {}
    for got, ref in zip(*sides):
        out = compare.merge_worst(out, compare.predict_numbers(got, ref))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=("tf32", "half_batch"), default="tf32")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        got = numbers(cell, seed, args.mode, device)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": got,
                          "limits": cell.limits,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
