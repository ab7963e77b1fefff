"""raster_bwd_roofline: kernel B2's share of its roofline over its
first launches of the spanned window: the least time at their inputs
(costs.raster_bound_s, from the working pairs the reference's plain
forward counts at the same constants) over their time by CUDA events
around the launches."""
from benchmark.harness.costs import pair_counts, raster_bound_s

SPANS = {"raster_bwd": ("selfcorr_tpu_torch.ops.rasterizer.kernel",
                        "raster_fused_bwd_cuda")}
KEEP = {"raster_bwd": (3, 0)}        # the consts of the first 3 launches
SIGMAS = (1e-4, 1e-3, 1e-4, 1e-2)    # render_fused's sigma1, sigma2, gammas


def read(ctx):
    kept = ctx.captured.get("raster_bwd", [])
    times = ctx.spans.get("raster_bwd", [])
    if not kept or len(times) < len(kept):
        return None
    bound = 0.0
    for i, consts in enumerate(kept):
        fwd = ctx.captured.get("raster_fwd", [])
        key = ("pairs", i)
        if key not in ctx.cache or i >= len(fwd) or not \
                fwd[i].equal(consts):
            ctx.cache[key] = pair_counts(consts, ctx.cfg.img_size, SIGMAS)
        bound += raster_bound_s(consts.shape, ctx.cfg.img_size,
                                ctx.cache[key], backward=True)
    return 100.0 * bound / (1e-3 * sum(times[:len(kept)]))
