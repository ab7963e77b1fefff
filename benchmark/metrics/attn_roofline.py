"""attn_roofline: kernel B3's share of its roofline over every launch
of the spanned window: the least time at its (B, H, T, d) inputs
(costs.attn_bound_s) over its time by CUDA events around the launches."""
from benchmark.harness.costs import attn_bound_s

SPANS = {"attn": ("selfcorr_tpu_torch.ops.attention",
                  "flash_attention_cuda")}
KEEP = {"attn": (1, 0)}              # q of the first launch, for its shape


def read(ctx):
    kept = ctx.captured.get("attn", [])
    times = ctx.spans.get("attn", [])
    if not kept or not times:
        return None
    return 100.0 * attn_bound_s(kept[0].shape) * len(times) \
        / (1e-3 * sum(times))
