"""raster_fwd_roofline: kernel B1's share of its roofline over its
first launches of the spanned window: the least time at their inputs
(costs.raster_bound_s, from the working pairs the reference's plain
forward counts) over their time by CUDA events around the launches."""
from benchmark.harness.costs import pair_counts, raster_bound_s

SPANS = {"raster_fwd": ("selfcorr_tpu_torch.ops.rasterizer.kernel",
                        "raster_fused_fwd_cuda")}
KEEP = {"raster_fwd": (3, 0)}        # the consts of the first 3 launches
SIGMAS = (1e-4, 1e-3, 1e-4, 1e-2)    # render_fused's sigma1, sigma2, gammas


def pairs_of(ctx, i):
    key = ("pairs", i)
    if key not in ctx.cache:
        consts = ctx.captured["raster_fwd"][i]
        ctx.cache[key] = pair_counts(consts, ctx.cfg.img_size, SIGMAS)
    return ctx.cache[key]


def read(ctx):
    kept = ctx.captured.get("raster_fwd", [])
    times = ctx.spans.get("raster_fwd", [])
    if not kept or len(times) < len(kept):
        return None
    bound = sum(raster_bound_s(kept[i].shape, ctx.cfg.img_size,
                               pairs_of(ctx, i), backward=False)
                for i in range(len(kept)))
    return 100.0 * bound / (1e-3 * sum(times[:len(kept)]))
