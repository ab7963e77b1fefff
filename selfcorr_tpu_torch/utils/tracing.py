"""Spans inside the port, on the profiler's clock.

Off by default: `span(name)` then returns one shared context that does
nothing. On (`enable()`), a span records its name, its parent (the span open around it on this thread),
the unit it belongs to, its host start and end (time.perf_counter_ns)
and, once CUDA is initialized, a pair of CUDA events on the current
stream. It also opens a profiler range of that name, so that an active
torch.profiler trace holds it over the device's operations, on one clock.
Nothing synchronizes: `read()` resolves the device times, after the
caller has synchronized.

The range is a RecordFunctionFast (an operator's scope, from torch's
private profiler bindings, imported on the on path only), not
torch.profiler.record_function (a user's scope): for a user's range the
profiler also writes a device-side range over the kernels launched inside
it, which a reader of the trace that counts every device event as busy
takes for device work (a traced predict call read 6.6% idle with them,
54.1% without; NVIDIA H100).

The outermost span open on a thread opens a unit (`train_step`,
`predict_batch`): the spans inside share its id. The last MAX_UNITS
units are kept, so a process that leaves the tracer on does not grow.

The tracer is one per process: its spans sit in library functions that
no caller hands an object to. The span names, where each sits and what
reads it are listed in PERF.md (section 3).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

MAX_UNITS = 4096
NO_SPAN = "(no span)"

_on = False
_units = collections.deque(maxlen=MAX_UNITS)
_ids = itertools.count(1)
_opened = 0                  # the id of the last unit opened
_names = set()               # every name a span was opened under
_local = threading.local()   # .stack: the open spans of this thread


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Unit:
    __slots__ = ("id", "name", "records")

    def __init__(self, uid: int, name: str):
        self.id, self.name = uid, name
        self.records = []


class _Record:
    __slots__ = ("name", "parent", "t0", "t1", "start", "end")

    def __init__(self, name: str, parent: int):
        self.name, self.parent = name, parent     # parent: index in unit
        self.t0 = self.t1 = self.start = self.end = None


class _Span:
    __slots__ = ("name", "unit", "index", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _opened
        from torch._C._profiler import _RecordFunctionFast
        stack = _stack()
        if stack:
            self.unit, parent = stack[-1].unit, stack[-1].index
        else:
            self.unit, parent = _Unit(next(_ids), self.name), -1
            _opened = self.unit.id
            _units.append(self.unit)
        _names.add(self.name)
        rec = _Record(self.name, parent)
        self.index = len(self.unit.records)
        self.unit.records.append(rec)
        stack.append(self)
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        rec.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self.unit.records[self.index]
        if rec.end is not None:
            rec.end.record()
        rec.t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def enabled() -> bool:
    return _on


def enable() -> bool:
    """Turn the tracer on; returns the state it found."""
    global _on
    was, _on = _on, True
    return was


def disable() -> bool:
    """Turn the tracer off; returns the state it found. Records stay."""
    global _on
    was, _on = _on, False
    return was


def reset() -> None:
    """Drop every record."""
    _units.clear()


def opened() -> int:
    """The id of the last unit opened (0 before the first): read(since=
    opened()) later reads only the units opened in between."""
    return _opened


def span(name: str):
    """A context that records the code inside as span `name` when the
    tracer is on, and does nothing when it is off."""
    if not _on:
        return _OFF
    return _Span(name)


def read(since: int = 0) -> dict:
    """The records of the units after unit `since`, their spans closed;
    device times need the device synchronized first.

    {"units": [{"id", "name", "spans": {name: {"parent", "calls",
    "host_ms", "self_ms", "device_ms"}}}], "spans": {name: {"units",
    "calls", "host_ms", "self_ms", "device_ms"}}}: per unit, then summed
    over the units. self_ms is host_ms less the part its child spans cover;
    device_ms is None where no CUDA events were recorded."""
    units, spans = [], {}
    for u in list(_units):
        if u.id <= since:
            continue
        child = [0] * len(u.records)      # ns of each record's children
        for r in u.records:
            if r.parent >= 0 and r.t1 is not None:
                child[r.parent] += r.t1 - r.t0
        per = {}
        for i, r in enumerate(u.records):
            if r.t1 is None:
                continue
            s = per.setdefault(r.name, {
                "parent": (u.records[r.parent].name if r.parent >= 0
                           else None),
                "calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                "device_ms": None})
            s["calls"] += 1
            s["host_ms"] += (r.t1 - r.t0) * 1e-6
            s["self_ms"] += (r.t1 - r.t0 - child[i]) * 1e-6
            if r.start is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) \
                    + r.start.elapsed_time(r.end)
        for name, s in per.items():
            t = spans.setdefault(name, {"units": 0, "calls": 0,
                                        "host_ms": 0.0, "self_ms": 0.0,
                                        "device_ms": None})
            t["units"] += 1
            for k in ("calls", "host_ms", "self_ms"):
                t[k] += s[k]
            if s["device_ms"] is not None:
                t["device_ms"] = (t["device_ms"] or 0.0) + s["device_ms"]
        units.append({"id": u.id, "name": u.name, "spans": per})
    return {"units": units, "spans": spans}


def table(rec: dict) -> list:
    """The lines of a readout of read()'s records: each span, indented
    under its parent, with its calls, host, device and self host ms a
    unit."""
    n = max(len(rec["units"]), 1)
    parent = {}
    for u in rec["units"]:
        for name, s in u["spans"].items():
            parent.setdefault(name, s["parent"])

    def depth(name):
        return 0 if parent.get(name) is None else 1 + depth(parent[name])
    lines = [f"[profile] spans over {len(rec['units'])} unit(s), a unit:",
             f"[profile] {'span':<30} {'calls':>6} {'host ms':>9} "
             f"{'device ms':>9} {'self ms':>9}"]
    for name, s in rec["spans"].items():
        dev = ("-" if s["device_ms"] is None
               else f"{s['device_ms'] / n:.3f}")
        lines.append(f"[profile] {'  ' * depth(name) + name:<30} "
                     f"{s['calls'] / n:>6.2f} {s['host_ms'] / n:>9.3f} "
                     f"{dev:>9} {s['self_ms'] / n:>9.3f}")
    return lines


def idle_by_span(events) -> dict:
    """The device's idle time (ms) between its first and last operation in
    the events of a torch.profiler run, each gap charged to the innermost
    program span (a name span() has opened) whose host range holds the
    gap's middle, or to NO_SPAN: the rule by which the benchmark's trace
    charges gaps to aten operations, keyed on the program's names. The
    device-side ranges of user annotations are not device work."""
    cuda = torch.autograd.DeviceType.CUDA
    busy, ranges = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                busy.append((s, t))
        elif e.name in _names:
            ranges.append((s, t, e.name))
    merged = []
    for s, t in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1])
                  for a, b in zip(merged, merged[1:]) if b[0] > a[1])
    ranges.sort()
    idle, active, j = {}, [], 0
    for mid, length in gaps:
        while j < len(ranges) and ranges[j][0] <= mid:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r[1] >= mid]
        label = (min(active, key=lambda r: r[1] - r[0])[2] if active
                 else NO_SPAN)
        idle[label] = idle.get(label, 0.0) + length * 1e-3
    return idle
