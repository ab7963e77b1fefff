"""predict_upload_ms: the predict call's upload (eval/tester.py
Tester.to_device: the host batch made float32 and copied to the device
from pageable memory), by the program's span `predict.upload`: its host ms
a call, the median over the calls the tracer recorded
(program_spans.py)."""
from benchmark.harness import program_spans as P

P.arm()


def read(ctx):
    return P.median(ctx, "predict_batch",
                    lambda u: P.field(u, "predict.upload", "host_ms"))
