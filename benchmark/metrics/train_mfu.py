"""train_mfu: the whole step's share of the card's published peaks: the
least time of its matrix work (the reference step's convolutions, linears
and products with their backward, counted from shapes; the trunk's
attention products at the bf16 peak, the rest at the float32 peak, as the
configuration states) over the spanned window's host seconds per step."""
from benchmark.harness.costs import least_step_s


def read(ctx):
    if not ctx.flops or not ctx.units:
        return None
    return 100.0 * least_step_s(*ctx.flops) / (ctx.span_s / ctx.units)
