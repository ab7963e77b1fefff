"""What the runners share: the two configurations built from a cell's
flags, the set-up clock, the kernels' launch counters, and the per-layer
context handed to the metric readers."""
from __future__ import annotations

import dataclasses
import gc
import time

import torch


def flag_values(cell, overrides: dict | None = None) -> dict:
    flags = dict(cell.config["flags"])
    flags.update(overrides or {})
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in flags.items()}


def program_config(flags: dict):
    from selfcorr_tpu_torch.configs import Config
    return Config(**flags)


def reference_config(flags: dict):
    from benchmark.reference.configs import Config
    return Config(**flags)


class SetupClock:
    """The parts of set-up, each the host seconds since the last mark;
    `total` from the process's start."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.last = t0
        self.parts = {}

    def mark(self, name: str, device) -> None:
        sync(device)
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.t0


def launches() -> dict:
    """The port's kernel launch counters, as they stand."""
    from selfcorr_tpu_torch.ops import attention
    from selfcorr_tpu_torch.ops.rasterizer import kernel
    return {**kernel.LAUNCHES, **attention.LAUNCHES}


def launches_off(before: dict, after: dict, units: int, per_unit: dict,
                 device) -> tuple:
    """(how many kernels launched other than units x per_unit times, a
    line that says so); every kernel not in per_unit should not launch.
    On the CPU the program runs its plain versions, so nothing is
    counted there and the check reads 0."""
    if device.type != "cuda":
        return 0, "launch check: not on the CPU (the plain versions run)"
    off, parts = 0, []
    for k in after:
        got = after[k] - before[k]
        want = units * per_unit.get(k, 0)
        off += got != want
        parts.append(f"{k} {got} (want {want})")
    return off, f"launches over {units} units: " + ", ".join(parts)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads: span times in ms by span, the kept
    inputs of the first calls, the units (steps or batches) and host
    seconds of the spanned window, the device trace, the whole step's
    matrix work (total, bf16) and a cache the readers share."""
    spans: dict
    captured: dict
    units: int
    span_s: float
    trace: object
    flops: tuple | None
    cfg: object
    cache: dict = dataclasses.field(default_factory=dict)


def spans_for(readers: dict):
    """The spans every reader of the cell asks for, merged."""
    from benchmark.harness.spans import Spans
    spec, keep = {}, {}
    for r in readers.values():
        spec.update(getattr(r, "SPANS", {}))
        keep.update(getattr(r, "KEEP", {}))
    return Spans(spec, keep)


# the device kernel each launch counter's wrapper starts (csrc/*.cu);
# B2 and B2' are one template
KERNEL_OF = {"raster_fused_fwd": "raster_fwd_kernel",
             "raster_fused_fwd_chunk": "raster_fwd_chunk_kernel",
             "raster_fused_bwd": "raster_bwd_kernel",
             "raster_fused_bwd_chunk": "raster_bwd_kernel",
             "dino_flash_attn": "flash_attn_kernel"}


def trace_launches(trace, before: dict, after: dict) -> str:
    """A line comparing the port's kernels in the trace with the launches
    their wrappers counted while it ran: the profiler has been seen to
    drop kernels at batch 32."""
    if trace is None:
        return "trace: the profiler recorded no device operation"
    parts = []
    for k, n in after.items():
        if n - before[k]:
            seen = sum(v[0] for name, v in trace.kernels.items()
                       if KERNEL_OF.get(k, k) in name)
            parts.append(f"{k} {seen} in the trace of {n - before[k]} "
                         f"launched")
    return "trace vs launches: " + (", ".join(parts) or "none launched")


def read_layers(readers: dict, ctx, out) -> None:
    """Fill out.busy_s, window_s, breakdown and the per-layer metrics
    that find something to read."""
    from benchmark.harness.trace import breakdown
    out.busy_s = ctx.trace.busy_s if ctx.trace else None
    out.window_s = ctx.trace.window_s if ctx.trace else None
    out.breakdown = breakdown(ctx.trace) if ctx.trace else None
    for name, r in readers.items():
        value = r.read(ctx)
        if value is not None:
            out.per_layer[name] = value
