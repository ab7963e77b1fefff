"""The device's trace over a short steady window: torch.profiler (CUPTI)
around a few units of the cell's work, read in memory and never written
to disk. Busy time is the union of the device's operation intervals
(kernels, copies, sets) within the window; the idle gaps between them are
labelled by the innermost host operation running at each gap's middle."""
from __future__ import annotations

import bisect
import dataclasses

import torch

WINDOW = "bench.trace_window"
SCAN = 400    # host events before a gap searched for the ones around it


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict          # {device op name: [count, seconds]}
    idle_by_host: dict     # {host op name: seconds of device idle}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(run_units) -> Trace | None:
    """Trace run_units() (which ends in a synchronize). None when the
    profiler recorded no device operation."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run_units()
    events = prof.events()
    win = [e for e in events if e.name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.name == WINDOW:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s = max(e.time_range.start, w0)
            t = min(e.time_range.end, w1)
            if t > s:
                dev.append((s, t, e.name))
        else:
            host.append(e)
    if not dev:
        return None
    kernels = {}
    for s, t, name in dev:
        k = kernels.setdefault(name[:160], [0, 0.0])
        k[0] += 1
        k[1] += (t - s) * 1e-6
    busy = _merge([(s, t) for s, t, _ in dev])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    idle = {}
    for s, t in gaps:
        if t <= s:
            continue
        mid = (s + t) / 2
        i = bisect.bisect_right(starts, mid)
        inner = [e for e in host[max(0, i - SCAN):i]
                 if e.time_range.end >= mid]
        label = (min(inner, key=lambda e: e.time_range.end
                     - e.time_range.start).name if inner else "(no host op)")
        idle[label[:160]] = idle.get(label[:160], 0.0) + (t - s) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(t - s for s, t in busy) * 1e-6,
                 kernels=kernels, idle_by_host=idle)


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time and the ten host
    operations under which the device idled longest, in seconds."""
    ops = sorted(((n, v[1]) for n, v in trace.kernels.items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(trace.idle_by_host.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
