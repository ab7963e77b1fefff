"""The data-parallel cell on the CPU, at a tiny size over four gloo ranks
(the port's CPU ranks), past the look for a card: the sound program passes
with every replica equal to rank 0's, each planted fault fails the number
that it moves, and a run whose rank loads JAX in its last phase prints no
result; the reference's step over one shard is the single-card step. On a
card: the TF32 control and the faults put in the reference's place fail
the cell's check."""
from __future__ import annotations

import functools
import time

import pytest
import torch

from benchmark import control
from benchmark.harness import compare, train_dp
from benchmark.harness.cell import resolve
from benchmark.tests.bench_tiny import TINY

CELL = "laptop_train_dp4"
SEED = 123456789012


def tiny_cell(workload: str = CELL):
    """The cell with its warm-up cut to the checked steps."""
    cell = resolve(workload)
    cell.traffic = {**cell.traffic,
                    "warmup_steps": cell.traffic["check_steps"]}
    return cell


def tiny_dp(plant=None, readers=()) -> tuple:
    """(correct, {number: (value, limit)}, the result) of a tiny run of
    the cell, the checked warm-up steps, one more that times them and a
    one-step window, traced where readers are named."""
    cell = tiny_cell()
    out = train_dp.run(cell, SEED, 0.1, bool(readers), torch.device("cpu"),
                       time.perf_counter(), dict.fromkeys(readers), TINY,
                       plant=control.PLANTS[plant] if plant else None)
    correct, rows = compare.judge(out.numbers, cell.limits)
    return correct, {k: (v, lim) for k, v, lim in rows}, out


def test_sound_traced_run_passes_with_equal_replicas():
    """The traced path too: rank 0 reads the per-layer metrics and prints
    the program's span tables; the exchange's span has no device time on
    the CPU, so all_mean_ms reads nothing there."""
    correct, got, out = tiny_dp(readers=["all_mean_ms", "train_mfu.dp"])
    assert correct, got
    assert got["replica_gap"] == (0.0, 0)
    assert set(out.per_layer) == {"train_mfu.dp"}, out.per_layer
    assert out.per_layer["train_mfu.dp"] > 0
    assert any("step.all_mean" in line for line in out.notes), out.notes


@pytest.mark.parametrize("plant,number", [
    ("sum", "loss_rel"),              # (a) the sum in place of the mean
    ("bn_local", "replica_gap"),      # (b) running statistics unaveraged
    ("no_exchange", "replica_gap"),   # (c) no exchange between ranks
    ("unchanged", "change_gap"),      # the state left as it was
    ("half_batch", "cont_loss_rel"),  # half of each rank's batch left out
])
def test_planted_fault_fails(plant, number):
    correct, got, _ = tiny_dp(plant)
    assert correct is False
    value, limit = got[number]
    assert value > limit, got


def plant_jax_after_the_window():
    """Rank 1 loads a module under JAX's name in its reference phase,
    which follows the window."""
    import json
    import sys

    import torch.distributed as dist

    from benchmark.reference.train import step
    real = step.train_step

    def loading(*args, **kwargs):
        if dist.get_rank() == 1:
            sys.modules["jax"] = json
        return real(*args, **kwargs)
    step.train_step = loading


def test_jax_loaded_by_a_rank_after_the_window_prints_no_result(
        monkeypatch):
    from benchmark.harness import cell as C
    from benchmark.tests.bench_tiny import tiny_run
    monkeypatch.setattr(C, "resolve", tiny_cell)
    monkeypatch.setattr(train_dp, "run", functools.partial(
        train_dp.run, plant=plant_jax_after_the_window))
    rc, line, err = tiny_run(CELL, seconds=0.1)
    assert rc == 1 and line is None, err[-3000:]
    assert "holds ['jax'] after the window" in err, err[-3000:]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_reference_step_over_equal_shards_is_the_single_step(n_shards):
    """Bit for bit against the single-card step written out plainly: one
    shard has nothing to average, and the mean of equal shards is each."""
    from benchmark.harness import common, inputs
    from benchmark.harness import weights as W
    from benchmark.reference.models.meshnet import (StepDraws,
                                                    build_mesh_constants,
                                                    device_constants,
                                                    forward_train)
    from benchmark.reference.train import step
    from benchmark.reference.train.optim import Optimizer, clip_and_guard
    cell = resolve(CELL)
    cfg = common.reference_config(common.flag_values(cell, TINY))
    cpu = torch.device("cpu")
    consts = build_mesh_constants(cfg)
    b = cfg.batch_size * cfg.repeat
    batch = inputs.train_pool(1, cfg.batch_size, cfg.repeat, 8, 24,
                              cfg.img_size, SEED, cpu)[0]
    draws = StepDraws(**inputs.step_draws(SEED, 0, b, cfg.symmetry_npts,
                                          False))
    sides = []
    for sharded in (False, True):
        model, dino = W.reference_modules(cfg, consts, SEED, cpu)
        model.train()
        dino.eval().requires_grad_(False)
        opt, dc = Optimizer(model, cfg), device_constants(consts, cpu)
        if sharded:
            aux, grads = step.train_step(model, dino, opt, dc,
                                         [(batch, draws)] * n_shards, cfg, 0)
        else:
            model.zero_grad(set_to_none=True)
            _, aux = forward_train(model, dino, batch, dc, cfg, 0, draws)
            aux["total_loss"].backward()
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            clip_and_guard(model)
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            opt.step(0)
        sides.append((aux, grads, model.state_dict()))
    (a0, g0, s0), (a1, g1, s1) = sides
    assert {k: float(v.detach()) for k, v in a0.items()} == \
        {k: float(v) for k, v in a1.items()}
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cell's sizes exist "
                    "only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("mode", ["tf32", "sum", "no_exchange"])
def test_reference_in_the_program_place_fails(cuda, mode):
    """At the cell's own size on one card, one seed; `python3
    benchmark/control.py` reads the same over several seeds."""
    cell = resolve(CELL)
    got = control.numbers(cell, 7, [mode], cuda)[mode]
    assert {k: v for k, v in got.items()
            if k in cell.limits and v > cell.limits[k]}, got
