"""Warm training-step time of checkouts of this package, in turns, on one
card: an A/B of two trees (or of the two rasterizer schedules) inside one
process tree, so both are timed on the same card.

  python -m selfcorr_tpu_torch.step_ab ROOT[:chunk] [ROOT[:chunk] ...]

Each argument names a checkout ROOT (its selfcorr_tpu_torch/ and config/
are used) and, with ":chunk", the dense-chunk rasterizer schedule
(api.COMPACT = False; only trees that have it). In the order given, one
subprocess per argument builds that tree's kernels, runs its training entry
point for one step at Wild6D-laptop width (config/wild6d/laptop.txt, batch
8 x 4 = 32, img 256, synthetic videos; chip_smoke.py's training path), then
times `--reps` warm train_step calls on one uploaded batch, each ending in
torch.cuda.synchronize(). Prints the card's name and power limit, one JSON
line per run and, last, all runs as one JSON object. Give parent and change
as parent, change, change, parent.

Run i trains in chiprun_out/step_ab/run<i>, emptied before it starts (the
Trainer resumes from any checkpoint there); the checkpoint the run writes is
removed after it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

_RUN = r"""
import json, math, os, statistics, sys, time
root, chunk, reps, out = (sys.argv[1], sys.argv[2] == "1",
                          int(sys.argv[3]), sys.argv[4])
sys.path.insert(0, root)
os.chdir(root)
import torch
from selfcorr_tpu_torch.data.loader import stack_items
from selfcorr_tpu_torch.models.meshnet import draw_step
from selfcorr_tpu_torch.ops.rasterizer import api
from selfcorr_tpu_torch.train import loop
from selfcorr_tpu_torch.train.step import train_step
if chunk:
    if not hasattr(api, "COMPACT"):
        raise SystemExit(f"{root} has no dense-chunk schedule")
    api.COMPACT = False
trainer = loop.main(["train", "--flagfile", "config/wild6d/laptop.txt",
                     "--dataset_name", "synthetic", "--total_iters", "1",
                     "--batch_log_interval", "1", "--checkpoint_dir", out,
                     "--name", "step_ab"])
cfg = trainer.cfg
ds = loop.make_train_dataset(cfg)
host = stack_items([ds.load_item(*a) for a in ds.sample_plan(0)])
# through loop, which has it in trees from before and after its move
# from train/step.py to data/loader.py
batch = trainer.upload(loop.compress_batch_host(host))
draws = draw_step(loop.step_generator(cfg.seed, 100), cfg,
                  batch["img"].shape[0])
train_step(trainer.state, batch, draws, cfg)
torch.cuda.synchronize()
times = []
for _ in range(reps):
    t0 = time.time()
    m = train_step(trainer.state, batch, draws, cfg)
    torch.cuda.synchronize()
    times.append((time.time() - t0) * 1e3)
    if not math.isfinite(float(m["total_loss"])):
        raise SystemExit("non-finite loss")
print("STEP_AB " + json.dumps({"step_ms": times,
                               "median_ms": statistics.median(times),
                               "batch": int(batch["img"].shape[0])}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", help="ROOT or ROOT:chunk")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = []
    for i, run in enumerate(args.runs):
        root, _, sched = run.partition(":")
        out = os.path.abspath(os.path.join("chiprun_out", "step_ab",
                                           f"run{i}"))
        shutil.rmtree(out, ignore_errors=True)
        proc = subprocess.run(
            [sys.executable, "-c", _RUN, os.path.abspath(root),
             "1" if sched == "chunk" else "0", str(args.reps), out],
            capture_output=True, text=True)
        shutil.rmtree(os.path.join(out, "step_ab", "ckpt"),
                      ignore_errors=True)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("STEP_AB ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            print(f"run {i} ({run}) failed with code {proc.returncode}")
            return 1
        res = dict(json.loads(line[0][8:]), run=run, order=i)
        results.append(res)
        print(json.dumps(res), flush=True)
    print(json.dumps({"card": smi, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
