"""ransac_draw_ms: the host's work in RANSAC's draw (ops/umeyama.py
draw_samples: the stable sort of the valid masks on the CPU, the gather of
the drawn indices and their upload), while the device has nothing queued:
the self host ms of the program's span `umeyama.draw` a call, which
leaves out its child `umeyama.draw.wait`, the copy that waits for the
device; the median over the calls the tracer recorded
(program_spans.py)."""
from benchmark.harness import program_spans as P

P.arm()


def read(ctx):
    return P.median(ctx, "predict_batch",
                    lambda u: P.field(u, "umeyama.draw", "self_ms"))
