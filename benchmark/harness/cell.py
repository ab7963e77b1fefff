"""A cell of BENCHMARK.json resolved to its files: the configuration, the
traffic mix, the limits of its comparison and the readers of its
per-layer metrics, each found by name under the benchmark's directory."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    limits: dict           # limits/<workload>.json: {number: limit}
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, bench_path: str | None = None) -> Cell:
    """The cell named `workload`; raises KeyError for an unknown name and
    FileNotFoundError for a missing file."""
    bench = _load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_load_json(os.path.join(BENCH_DIR, "configs",
                                       f"{w['config']}.json")),
        traffic=_load_json(os.path.join(BENCH_DIR, "traffic",
                                        f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(BENCH_DIR, "limits",
                                       f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str):
    """The module benchmark/metrics/<name>.py: its SPANS {span: (module,
    attribute)} to wrap in the traced run, and read(ctx) -> value or
    None."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
