"""The readers of the program's own spans on the CPU: each
entry point's runner at the tiny size with --trace 1's readers of
program spans (the benchmark's outside spans time by CUDA events, so they
are left out here), and a program without a tracer, which reads
nothing."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import predict, program_spans, train
from benchmark.tests.bench_tiny import TINY

READERS = {"laptop_train": ["step_backward_ms", "update_host_ms"],
           "laptop_predict": ["predict_upload_ms", "ransac_draw_ms"]}


@pytest.fixture(autouse=True)
def tracer_off():
    from selfcorr_tpu_torch.utils import tracing
    was = tracing.disable()
    tracing.reset()
    yield
    tracing.reset()
    (tracing.enable if was else tracing.disable)()


@pytest.mark.parametrize("workload", sorted(READERS))
def test_traced_run_reports_the_program_spans(workload):
    """Host ms come out; the device ms of the backward does not without
    CUDA events."""
    cell = C.resolve(workload)
    readers = {n: C.metric_reader(n) for n in READERS[workload]}
    runner = {"train_step": train.run,
              "predict_batch": predict.run}[cell.traffic["entry"]]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = runner(cell, 123456789012, 0.5, True, torch.device("cpu"),
                     time.perf_counter(), readers, TINY)
    finally:
        torch.set_num_threads(threads)
    want = set(READERS[workload]) - {"step_backward_ms"}
    assert set(out.per_layer) == want, out.per_layer
    for name in want:
        assert 0 < out.per_layer[name] < 60_000, name


@pytest.mark.parametrize("name", sorted(sum(READERS.values(), [])))
def test_program_without_a_tracer_reads_nothing(name, monkeypatch):
    from benchmark.harness.common import LayerContext
    from benchmark.reference.configs import Config
    monkeypatch.setattr(program_spans, "_tracer", lambda: None)
    reader = C.metric_reader(name)
    ctx = LayerContext(spans={}, captured={}, units=1, span_s=1.0,
                       trace=None, flops=None, cfg=Config())
    assert reader.read(ctx) is None
