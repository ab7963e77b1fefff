"""The program's own spans (selfcorr_tpu_torch/utils/tracing.py), for the
readers of the per-layer metrics the program records itself. A reader
calls arm() when it is loaded, which run.py does only with --trace 1, so
the untraced runs, which give the end-to-end metrics, keep the tracer off;
the traced run then measures every per-layer metric with the tracer on.

The tracer records every unit of the run alike: the warm-up, the spanned
window and the profiled units. So a reader takes the median over the
units of its entry point; the warm-up and profiled units, under 7% of
them, do not move it. A checkout whose program has no tracer reads
nothing: every value is None."""
from __future__ import annotations

import statistics


def _tracer():
    try:
        from selfcorr_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def arm() -> None:
    """Turn the program's tracer on, where the program has one."""
    tracing = _tracer()
    if tracing is not None:
        tracing.enable()


def median(ctx, unit: str, value):
    """The median of value(u) over the recorded units named `unit` (the
    entry point's span), leaving out those where it is None; None where
    nothing is left. The records are read once a run (ctx.cache)."""
    if "program_spans" not in ctx.cache:
        tracing = _tracer()
        ctx.cache["program_spans"] = (tracing.read()["units"]
                                      if tracing is not None else [])
    got = [value(u) for u in ctx.cache["program_spans"]
           if u["name"] == unit]
    got = [v for v in got if v is not None]
    return statistics.median(got) if got else None


def field(u: dict, span: str, key: str):
    """Span `span`'s `key` (host_ms, self_ms, device_ms, calls) in unit u,
    or None where the unit has no such span."""
    s = u["spans"].get(span)
    return None if s is None else s[key]
