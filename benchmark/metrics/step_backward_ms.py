"""step_backward_ms: the training step's backward (train/step.py:
total.backward() and the zero-fill of the gradients the loss did not
reach), by the program's span `step.backward`: its CUDA-event ms a step,
the median over the steps the tracer recorded (program_spans.py). None
without CUDA events."""
from benchmark.harness import program_spans as P

P.arm()


def read(ctx):
    return P.median(ctx, "train_step",
                    lambda u: P.field(u, "step.backward", "device_ms"))
