"""The benchmark's harness on the CPU: BENCHMARK.json against the
contract's shape, every cell resolved to its files, the yardstick's
counts against hand-worked shapes, and the reference against the port at
a tiny size."""
from __future__ import annotations

import json
import math
import os
import re

import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import costs
from benchmark.tests.bench_tiny import tiny_run

BENCH = json.load(open(os.path.join(C.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in CELLS
            # the cell reports the end-to-end metric the layer moves
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    # four chips only where the cell measures what exists across chips:
    # at most a quarter of the cells, or one
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4), four
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(C.ROOT, c["file"]))
        assert c["reduced"] == []


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = C.resolve(workload)
    assert cell.traffic["entry"] in ("train_step", "train_step_dp",
                                     "predict_batch")
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        reader = C.metric_reader(m["name"])
        assert callable(reader.read)
    prior = cell.config["flags"]["shape_prior_path"]
    assert prior.startswith("benchmark/configs/") and os.path.exists(
        os.path.join(C.ROOT, prior))


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        C.resolve("no_such_cell")


def test_conv_and_linear_flops_by_hand():
    """2 * out * (in * kh * kw) multiply-adds per output pixel; backward
    twice the forward."""
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    x = torch.randn(2, 3, 16, 16, requires_grad=True)
    with costs.count_flops() as counter:
        conv(x).sum().backward()
    fwd = 2 * 2 * 8 * 16 * 16 * 3 * 3 * 3
    assert counter.get_total_flops() == 3 * fwd
    lin = torch.nn.Linear(64, 32)
    with costs.count_flops() as counter:
        lin(torch.randn(10, 64))
    assert counter.get_total_flops() == 2 * 10 * 64 * 32


def test_attention_flops_match_the_reference_trunk():
    """costs.attn_flops counts exactly the products the reference's plain
    attention runs: 4 B H T^2 d a block."""
    from benchmark.reference.configs import Config
    from benchmark.reference.ops.attention import flash_attention_plain
    cfg = Config(img_size=96)                  # T = 145: a ragged tile
    t = (96 // 8) ** 2 + 1
    q = torch.randn(2, 6, t, 64).bfloat16()
    with costs.count_flops() as counter:
        flash_attention_plain(q, q, q)
    assert counter.get_total_flops() == costs.attn_flops(cfg, 2, blocks=1)
    assert costs.attn_flops(Config(img_size=256), 32) == \
        9 * 4 * 32 * 6 * 1025 * 1025 * 64


def test_bounds_by_hand():
    # B3 at the trunk's inputs: 4 B H T^2 d at 989 TFLOP/s
    assert math.isclose(costs.attn_bound_s((32, 6, 1025, 64)),
                        4 * 32 * 6 * 1025 ** 2 * 64 / 989e12)
    # B1 with one pair of each kind in a (1, 16, 64) render at S = 4:
    # 171 operations, or 16 * 64 * 4 + 13 * 16 * 4 bytes
    pairs = {"cover": 1, "cover1": 1, "cover2": 1, "tex": 1, "depth": 1}
    assert math.isclose(costs.raster_bound_s((1, 16, 64), 4, pairs, False),
                        max(171 / 67e12, (4096 + 832) / 3.35e12))
    big = {k: 10 ** 9 for k in pairs}
    assert math.isclose(costs.raster_bound_s((1, 16, 64), 4, big, True),
                        252e9 / 67e12)
    assert costs.least_step_s(67e12 + 989e12, 989e12) == pytest.approx(2.0)


def test_pair_counts_of_one_covering_face():
    """A face filling the image covers every pixel at both sigmas."""
    from benchmark.reference.ops.rasterizer import common as RC
    fv = torch.tensor([[[[-3.0, -3.0, 3.0], [3.0, -3.0, 3.0],
                         [0.0, 3.0, 3.0]]]])
    tex = torch.zeros(1, 1, 3, 3)
    consts = RC.pack_constants(fv, tex, tex, n_bands=RC.bands_for(8))
    pairs = costs.pair_counts(consts, 8, (1e-4, 1e-3, 1e-4, 1e-2))
    assert pairs["cover1"] == pairs["cover2"] == 64


@pytest.mark.parametrize("workload", CELLS)
def test_reference_against_the_port_tiny(workload):
    """A whole run at the tiny size on the CPU: the port (its plain
    versions) and the reference agree, and the result line has the
    contract's keys."""
    rc, line, err = tiny_run(workload)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert list(line)[-1] == "checked"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    for v in line["checked"].values():
        assert v["value"] <= v["limit"]
