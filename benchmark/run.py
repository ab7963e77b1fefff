"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic mix (BENCHMARK.json names
them; their files are under benchmark/configs and benchmark/traffic),
makes the weights and inputs on the card from --seed, warms up, measures
for --seconds, then compares what the timed path produced with the plain
reference (benchmark/reference) and prints, as its last line of standard
output, one JSON object: correct, attempted, failed, the metrics (the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), the device, and with --trace 1 the trace's breakdown. Set-up's
parts and notes go to standard error, and the numbers compared, each
beside its limit, are its last lines.

Exits 2 without a CUDA device (or with fewer than the cell asks for), and
1 if the process, or a rank process it started, holds JAX or the JAX
package after the window. Caches of the program's builds stay inside the
checkout."""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "selfcorr_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (selfcorr_tpu_torch is not selfcorr_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result(cell, out, trace: bool, device) -> tuple:
    """(correct, the JSON object of the result line)."""
    import torch
    from benchmark.harness.compare import judge
    correct, rows = judge(out.numbers, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = dict(out.per_layer) if trace else dict(out.metrics)
    if not trace:
        values["setup_s"] = out.setup_s
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": out.memory_peak}
    if trace:
        dev["busy_s"] = out.busy_s
        dev["window_s"] = out.window_s
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": dev}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return correct, line


def main(argv=None, device=None, flag_overrides=None) -> int:
    """One run. `device` and `flag_overrides` are for the CPU tests, which
    drive a run at a small size without a card; the benchmark itself
    passes neither."""
    args = parse(argv)
    from benchmark.harness.cell import metric_reader, resolve
    cell = resolve(args.workload)
    import torch
    # one host thread for PyTorch's CPU operations: the runs' load comes
    # from one process with few threads, and on the card's 8-core host a
    # pool of 8 intra-op threads doubled the spread of predict's latency
    # tail (PERF.md)
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"no result: the cell needs {cell.chips} CUDA device(s), "
                f"this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from benchmark.harness import predict, train, train_dp
    runners = {"train_step": train.run, "train_step_dp": train_dp.run,
               "predict_batch": predict.run}
    readers = ({m["name"]: metric_reader(m["name"]) for m in cell.per_layer}
               if args.trace else {})
    out = runners[cell.traffic["entry"]](
        cell, args.seed, args.seconds, bool(args.trace), device, T0,
        readers, flag_overrides)
    # a cell on several chips runs in rank processes, which report theirs
    found = sorted(set(forbidden_modules()) | set(getattr(out, "forbidden",
                                                          [])))
    if found:
        log(f"no result: the process holds {found} after the window")
        return 1
    log("setup parts (s): " + json.dumps(out.setup_parts))
    log(f"reference and comparison (s, not in setup_s): {out.reference_s}")
    for note in out.notes:
        log(note)
    correct, line = result(cell, out, bool(args.trace), device)
    for k, v in line["checked"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
