"""update_host_ms: the host's time in the training step's update, the
program's spans `step.clip` (train/optim.py clip_and_guard: per-group
clipping and the NaN guard, a few operations a parameter tensor) and
`step.optimizer` (AdamW with the OneCycle rates): their host ms summed a
step, the median over the steps the tracer recorded (program_spans.py).
The launches of ~330 tensors' operations, and any wait on a full launch
queue inside them, are what it counts."""
from benchmark.harness import program_spans as P

P.arm()


def _update(u):
    clip = P.field(u, "step.clip", "host_ms")
    opt = P.field(u, "step.optimizer", "host_ms")
    return None if clip is None or opt is None else clip + opt


def read(ctx):
    return P.median(ctx, "train_step", _update)
