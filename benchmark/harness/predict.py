"""The runner of the `predict_batch` traffic: the program's
Tester.predict_batch (the eval forward, then the whole-batch
RANSAC-Umeyama fit), the unit of Tester.test, in a closed loop with one
client.

Set-up makes the weights, a Tester around them, and a pool of host batches
of distinct test frames, each with its colour jitter and the seed of its
RANSAC uniforms. Call i takes entry i of the pool in turn: the upload
happens inside the call, as in evaluation, and the call ends when its
poses and boxes are on the host. Every answer of the run is compared with
the reference's answer to its entry."""
from __future__ import annotations

import contextlib
import json
import statistics
import tempfile
import time
from types import SimpleNamespace

import torch

from benchmark.harness import common, compare, inputs
from benchmark.harness import trace as T
from benchmark.harness import weights as W

ANSWERS = ("rotation", "translation", "scale_fit", "bbox9", "ok")


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        readers: dict, flag_overrides: dict | None = None) -> SimpleNamespace:
    clock = common.SetupClock(t0)
    tr = cell.traffic
    flags = common.flag_values(cell, flag_overrides)
    from selfcorr_tpu_torch.eval.tester import Tester
    from selfcorr_tpu_torch.models.meshnet import MeshNet, \
        build_mesh_constants
    rundir = tempfile.TemporaryDirectory(prefix="bench_predict_")
    flags.update(checkpoint_dir=rundir.name, name="predict")
    pcfg, rcfg = common.program_config(flags), common.reference_config(flags)
    clock.mark("import", device)
    if device.type == "cuda":
        torch.zeros((), device=device)
    clock.mark("cuda_init", device)

    from benchmark.reference.models.meshnet import \
        build_mesh_constants as ref_constants
    rconst = ref_constants(rcfg)
    ref_model, _ = W.reference_modules(rcfg, rconst, seed, device)
    ref_model.eval()
    clock.mark("weights", device)
    with torch.device("meta"):
        model = MeshNet(pcfg, build_mesh_constants(pcfg))
    model = W.load_into(model, ref_model.state_dict(), device)
    tester = Tester(pcfg, model=model)
    clock.mark("program_state", device)

    bs, n_pool = tr["batch"], tr["pool_batches"]
    pool = inputs.test_pool(n_pool, bs, tr["videos"], tr["frames_per_video"],
                            rcfg.img_size, seed, device)
    draws = [inputs.predict_draws(seed, j) for j in range(n_pool)]
    clock.mark("inputs", device)

    # every answer of the run, written into arrays made here, so that the
    # window adds no Python objects for the collector to walk
    cap = tr["warmup_calls"] + tr["profile_calls"] + int(seconds * 200) + 1
    store = Answers(cap, bs, device)
    before = common.launches()
    state = {"units": 0}

    def call(keep: bool):
        j = state["units"] % n_pool
        jitter, rseed = draws[j]
        tester.generator = torch.Generator().manual_seed(rseed)
        _, fit = tester.predict_batch(pool[j], jitter=jitter)
        store.put(j, fit, keep)
        state["units"] += 1

    for _ in range(tr["warmup_calls"]):
        call(True)
    clock.mark("warmup", device)
    out = SimpleNamespace(setup_s=clock.total(), setup_parts=dict(clock.parts),
                          metrics={}, per_layer={}, breakdown=None,
                          busy_s=None, window_s=None, notes=[])
    n0 = state["units"]
    lat = []
    spans = common.spans_for(readers) if trace else None
    with (spans.active() if trace else contextlib.nullcontext()):
        start = time.perf_counter()
        while True:
            t = time.perf_counter()
            call(True)
            now = time.perf_counter()
            lat.append(now - t)
            if now - start >= seconds:
                break
        window = time.perf_counter() - start
    units = state["units"] - n0
    out.attempted = units
    out.notes.append(f"{units} batches, latency median "
                     f"{1e3 * statistics.median(lat)} ms")
    if not trace:
        out.metrics["predict_frames_per_s"] = units * bs / window
        out.metrics["predict_batch_ms_p95"] = 1e3 * statistics.quantiles(
            lat, n=20, method="inclusive")[18]
    else:
        l0 = common.launches()

        def profiled():
            for _ in range(tr["profile_calls"]):
                call(False)
            common.sync(device)
        prof = T.profile(profiled)
        out.notes.append(common.trace_launches(prof, l0, common.launches()))
    out.memory_peak = common.memory_peak(device)
    off, line = common.launches_off(before, common.launches(),
                                    state["units"], tr["launches_per_unit"],
                                    device)
    out.notes.append(line)
    out.failed = store.failed()
    del tester, model
    common.free(device)
    rundir.cleanup()

    t_ref = time.perf_counter()
    from benchmark.reference.eval.predict import predict_batch
    numbers = {}
    for j in range(n_pool):
        jitter, rseed = draws[j]
        fit = predict_batch(ref_model, rconst, rcfg, pool[j], jitter, rseed,
                            device)
        ref = {k: fit[k].cpu() for k in ANSWERS}
        for got in store.of_entry(j):
            numbers = compare.merge_worst(numbers,
                                          compare.predict_numbers(got, ref))
    numbers["launches_off"] = off
    out.numbers = numbers
    out.reference_s = time.perf_counter() - t_ref
    out.notes.append(f"compared {store.n} answers of {bs} frames, "
                     f"{int(store.ok[:store.n].sum())} frames fitted")
    out.notes.append("numbers: " + json.dumps(numbers))

    if trace:
        ctx = common.LayerContext(
            spans=spans.ms(), captured=spans.captured, units=units,
            span_s=window, trace=prof, flops=None, cfg=rcfg)
        common.read_layers(readers, ctx, out)
    return out


class Answers:
    """The poses and boxes of up to `cap` calls of `batch` frames, copied
    to the host into pinned buffers, with the pool entry of each call."""

    SHAPES = {"rotation": (3, 3), "translation": (1, 3), "scale_fit": (1, 1),
              "bbox9": (9, 3)}

    def __init__(self, cap: int, batch: int, device):
        pin = device.type == "cuda"
        self.n, self.cap = 0, cap
        self.entry = torch.zeros(cap, dtype=torch.long)
        self.host = {k: torch.zeros((cap, batch) + s).pin_memory()
                     if pin else torch.zeros((cap, batch) + s)
                     for k, s in self.SHAPES.items()}
        self.ok = torch.zeros((cap, batch), dtype=torch.bool)

    def put(self, entry: int, fit: dict, keep: bool) -> None:
        """Copy the call's answers to the host (the call ends when they are
        there); keep them when `keep` and there is room."""
        i = min(self.n, self.cap - 1)
        for k in self.SHAPES:
            self.host[k][i].copy_(fit[k])
        self.ok[i].copy_(fit["ok"])
        if keep and self.n < self.cap:
            self.entry[i] = entry
            self.n += 1

    def of_entry(self, j: int):
        for i in torch.nonzero(self.entry[:self.n] == j).flatten().tolist():
            out = {k: v[i] for k, v in self.host.items()}
            out["ok"] = self.ok[i]
            yield out

    def failed(self) -> int:
        """Calls whose answers hold a value that is not finite."""
        bad = torch.zeros(self.n, dtype=torch.bool)
        for v in self.host.values():
            bad |= ~torch.isfinite(v[:self.n]).flatten(1).all(1)
        return int(bad.sum())
