"""all_mean_ms: the exchange between ranks in the data-parallel training
step (train/step.py: parallel.all_mean_ of the gradients, aux losses and
BatchNorm running statistics, one coalesced all-reduce), by the program's
span `step.all_mean`: its CUDA-event ms a step on rank 0's stream, the
median over the steps the tracer recorded (program_spans.py). The
exchange starts once the backward has returned, so this is its exposed
time, the wait for the slowest rank included. None without CUDA events or
without a group."""
from benchmark.harness import program_spans as P

P.arm()


def read(ctx):
    return P.median(ctx, "train_step",
                    lambda u: P.field(u, "step.all_mean", "device_ms"))
