"""device_idle_pct.predict: the share of the traced window of predict
calls, one client in a closed loop, in which no operation ran on the
device (torch.profiler, the union of the device's operation
intervals)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
