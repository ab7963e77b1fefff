"""predict_forward_ms: the eval forward (models/meshnet.py forward_test:
ResNet18 + FPN, the heads, the dual-softmax correspondence and its
confidence), by CUDA events around its call in eval/tester.py, ms per
batch over the spanned window."""

SPANS = {"forward_test": ("selfcorr_tpu_torch.eval.tester", "forward_test")}


def read(ctx):
    times = ctx.spans.get("forward_test", [])
    if not times or not ctx.units:
        return None
    return sum(times) / ctx.units
