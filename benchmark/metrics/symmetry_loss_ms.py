"""symmetry_loss_ms: the training forward's symmetry loss (the mirrored
or rotated surface samples against the mesh, a chamfer over
symmetry_npts points per rotation), its forward by CUDA events around its
call in models/meshnet.py, ms per step over the spanned window."""

SPANS = {"symmetry_loss": ("selfcorr_tpu_torch.models.meshnet",
                           "symmetry_loss")}


def read(ctx):
    times = ctx.spans.get("symmetry_loss", [])
    if not times or not ctx.units:
        return None
    return sum(times) / ctx.units
