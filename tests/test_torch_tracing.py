"""The port's tracer (selfcorr_tpu_torch/utils/tracing.py) on the CPU at a
tiny size: off, the training step and the predict call leave no record
and no range in a profiler's trace; on, they give the same outputs and
states bit for bit, each span once a unit under its parent, and RANSAC's
draw with no sort and no copy to the host inside its span. Then the idle
charge of a hand-built trace, reading the units since a mark and their
table, the bound on the units kept, and the off path's allocations."""
import collections
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_threads import share_cores  # noqa: F401 (autouse)

from selfcorr_tpu_torch import parallel as P
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.eval.tester import Tester
from selfcorr_tpu_torch.models.meshnet import build_mesh_constants, draw_step
from selfcorr_tpu_torch.ops.umeyama import draw_samples
from selfcorr_tpu_torch.train.step import init_state, train_step
from selfcorr_tpu_torch.utils import tracing

TINY = dict(img_size=32, corr_h=8, corr_w=8, subdivide=1, batch_size=2,
            repeat=2, total_iters=10, symmetry_idx=0, symmetry_npts=256,
            use_depth=True, divide_fn="both", pretrain_k=8, n_corr_feat=16,
            codedim=8, depth_offset=5.0, dino_attn_bf16=False,
            ransac_iters=8, pose_fit_max_points=512, device="cpu")

# span: its parent, in the order the spans open
TRAIN = {"train_step": None, "step.decompress": "train_step",
         "step.forward": "train_step", "forward.encode": "step.forward",
         "forward.render": "step.forward", "forward.losses": "step.forward",
         "loss.symmetry": "forward.losses", "forward.dino": "step.forward",
         "forward.cycle": "step.forward", "step.backward": "train_step",
         "step.clip": "train_step", "step.optimizer": "train_step"}
# with a process group, the mean across ranks follows the backward
TRAIN_GROUP = dict(list(TRAIN.items())[:list(TRAIN).index("step.clip")]
                   + [("step.all_mean", "train_step")]
                   + list(TRAIN.items())[list(TRAIN).index("step.clip"):])
SPANS = {
    "train": TRAIN,
    "train_group": TRAIN_GROUP,
    "predict": {"predict_batch": None, "predict.upload": "predict_batch",
                "umeyama.draw": "predict_batch"}}
ALL_NAMES = {n for spans in SPANS.values() for n in spans}


@pytest.fixture(autouse=True)
def tracer_reset():
    was = tracing.disable()
    tracing.reset()
    yield
    tracing.reset()
    (tracing.enable if was else tracing.disable)()


def host_batch(seed=0, b=4, s=32) -> dict:
    rng = np.random.RandomState(seed)
    mask = np.zeros((b, s, s), np.float32)
    mask[:, s // 4: 3 * s // 4, s // 4: 3 * s // 4] = 1.0
    return {"img": rng.rand(b, s, s, 3).astype(np.float32), "mask": mask,
            "depth": (mask * (5.0 + rng.rand(b, s, s))).astype(np.float32),
            "occ": np.zeros((b, s, s), np.float32),
            "pp_crop": np.zeros((b, 2), np.float32),
            "foc_crop": np.full((b, 2), 2.0, np.float32)}


def train_once(group):
    """One train_step from the seeded init: its metrics, then the model's
    parameters and buffers and AdamW's moments after it."""
    cfg = Config(**TINY)
    state = init_state(cfg, build_mesh_constants(cfg), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in host_batch().items()}
    draws = draw_step(torch.Generator().manual_seed(0), cfg, 4)
    out = dict(train_step(state, batch, draws, cfg, group))
    out.update({f"param.{n}": p.detach().clone()
                for n, p in state.model.named_parameters()})
    out.update({f"buffer.{n}": b.clone()
                for n, b in state.model.named_buffers()})
    for i, s in enumerate(state.optimizer.adamw.state.values()):
        out.update({f"adamw.{i}.{k}": v.clone() for k, v in s.items()
                    if torch.is_tensor(v)})
    return out


def predict_once(tester):
    tester.generator = torch.Generator().manual_seed(7)
    pred, fit = tester.predict_batch(host_batch(1))
    return {**{f"pred.{k}": v for k, v in pred.items()
               if torch.is_tensor(v)},
            **{f"fit.{k}": v for k, v in fit.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(case, on): (outputs, records, the profiler's (name, start, end,
    is a user annotation) host ranges)} of each entry point run once with the tracer off and
    once on, each under a CPU torch.profiler; and the tester."""
    tester = Tester(Config(**TINY, checkpoint_dir=str(
        tmp_path_factory.mktemp("trace")), name="t"))
    out = {}
    for case in SPANS:
        group = None
        if case == "train_group":
            P.init_distributed(0, 1, f"127.0.0.1:{P.free_port()}", "cpu")
            group = dist.group.WORLD
        try:
            for on in (False, True):
                (tracing.enable if on else tracing.disable)()
                tracing.reset()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]) \
                        as prof:
                    got = (predict_once(tester) if case == "predict"
                           else train_once(group))
                tracing.disable()
                ranges = [(e.name, e.time_range.start, e.time_range.end,
                           e.is_user_annotation) for e in prof.events()]
                out[case, on] = (got, tracing.read(), ranges)
        finally:
            if group is not None:
                dist.destroy_process_group()
    tracing.reset()
    return out, tester


@pytest.mark.parametrize("case", ["train", "predict"])
def test_off_leaves_no_records_and_no_ranges(runs, case):
    _, rec, ranges = runs[0][case, False]
    assert rec["units"] == [] and rec["spans"] == {}
    assert not ALL_NAMES & {r[0] for r in ranges}


@pytest.mark.parametrize("case", list(SPANS))
def test_on_matches_off_bit_for_bit(runs, case):
    off, on = runs[0][case, False][0], runs[0][case, True][0]
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("case", list(SPANS))
def test_each_span_once_a_unit_under_its_parent(runs, case):
    _, rec, ranges = runs[0][case, True]
    (unit,) = rec["units"]
    assert unit["name"] == next(iter(SPANS[case]))
    assert {k: s["parent"] for k, s in unit["spans"].items()} \
        == SPANS[case]
    assert list(unit["spans"]) == list(SPANS[case])
    for name, s in unit["spans"].items():
        assert s["calls"] == 1 and s["device_ms"] is None, name
        assert 0 <= s["self_ms"] <= s["host_ms"], name
    # every span is a range of the profiler's trace, and not a user
    # annotation, for which the profiler would draw a device-side range
    seen = collections.Counter(r[0] for r in ranges if not r[3])
    assert all(seen[name] == 1 for name in SPANS[case])
    assert not any(r[3] for r in ranges if r[0] in SPANS[case])


def test_the_draw_neither_sorts_nor_reads_the_mask_on_the_host(runs):
    """No aten::sort runs inside umeyama.draw: the call's one sort is the
    pixel selection's, outside the draw. And the draw runs on a mask on
    the meta device, which holds no values, so nothing inside its span
    copies the mask to the host."""
    _, _, ranges = runs[0]["predict", True]
    spans = {r[0]: r[1:3] for r in ranges if r[0] in ALL_NAMES}
    sorts = [r[1:3] for r in ranges if r[0] == "aten::sort"]

    def inside(r, span):
        return spans[span][0] <= r[0] and r[1] <= spans[span][1]
    assert sum(inside(r, "predict_batch") for r in sorts) == 1
    assert sum(inside(r, "umeyama.draw") for r in sorts) == 0

    tracing.enable()
    idx = draw_samples(torch.ones((2, 64), dtype=torch.bool, device="meta"),
                       8, 5, torch.Generator().manual_seed(0))
    tracing.disable()
    assert idx.device.type == "meta" and idx.shape == (2, 8, 5)
    (unit,) = tracing.read()["units"]
    assert list(unit["spans"]) == ["umeyama.draw"]


def _event(name, start, end, cuda=False, annotation=False):
    kind = torch.autograd.DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=kind.CUDA if cuda else kind.CPU,
        is_user_annotation=annotation)


def test_idle_by_span_charges_the_innermost_span():
    """Device ops at 0-10, 20-30, 31-40 (overlapping 35-38), 60-70 and
    100-110 us; program spans outer 0-80 holding inner 15-50, an aten op
    (not a program span) 15-35, and gaps 10-20 (middle 15: inner),
    30-31 (inner), 40-60 (middle 50: inner, closed at 50), 70-100
    (middle 85: no span). A device-side user annotation over 0-110 is
    not device work."""
    tracing.enable()
    for name in ("outer", "inner"):
        with tracing.span(name):
            pass
    tracing.disable()
    events = [_event("outer", 0, 80), _event("inner", 15, 50),
              _event("aten::mul", 15, 35),
              _event("outer", 0, 110, cuda=True, annotation=True)]
    events += [_event("k", s, e, cuda=True)
               for s, e in ((0, 10), (20, 30), (31, 40), (35, 38),
                            (60, 70), (100, 110))]
    got = tracing.idle_by_span(events)
    assert got == pytest.approx({"inner": 0.031, tracing.NO_SPAN: 0.030})
    events[1] = _event("inner", 15, 45)     # 40-60 now falls to outer
    got = tracing.idle_by_span(events)
    assert got == pytest.approx({"inner": 0.011, "outer": 0.020,
                                 tracing.NO_SPAN: 0.030})


def test_read_since_a_mark_and_its_table():
    """read(since=opened()) reads only the units opened after the mark;
    the table indents each span under its parent and gives its calls a
    unit, and self time leaves out the children."""
    tracing.enable()
    with tracing.span("before"):
        pass
    mark = tracing.opened()
    for _ in range(2):
        with tracing.span("outer"):
            for _ in range(3):
                with tracing.span("inner"):
                    sum(range(1000))
    tracing.disable()
    rec = tracing.read(since=mark)
    assert [u["name"] for u in rec["units"]] == ["outer", "outer"]
    assert set(rec["spans"]) == {"outer", "inner"}
    assert rec["spans"]["outer"]["units"] == 2
    assert rec["spans"]["inner"]["calls"] == 6
    outer = rec["spans"]["outer"]
    assert outer["self_ms"] == pytest.approx(
        outer["host_ms"] - rec["spans"]["inner"]["host_ms"])
    lines = tracing.table(rec)
    assert lines[0] == "[profile] spans over 2 unit(s), a unit:"
    (row,) = [ln for ln in lines if "inner" in ln]
    assert row.startswith("[profile]   inner ")
    assert row.split()[2] == "3.00" and row.split()[4] == "-"


def test_records_stay_bounded():
    tracing.enable()
    first = tracing.opened() + 1
    for _ in range(tracing.MAX_UNITS + 5):
        with tracing.span("unit"):
            with tracing.span("inner"):
                pass
    tracing.disable()
    rec = tracing.read()
    assert len(rec["units"]) == tracing.MAX_UNITS
    assert rec["units"][0]["id"] == first + 5
    assert rec["spans"]["inner"]["calls"] == tracing.MAX_UNITS


def test_off_path_allocates_nothing():
    def sites():
        for _ in range(1000):
            with tracing.span("a"):
                pass
    sites()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        sites()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, tracing.__file__)]
    grown = after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno")
    assert sum(d.size_diff for d in grown) <= 0
    assert tracing.read()["units"] == []
