"""pose_fit_ms: the whole-batch pose fit (eval/pose_fit.py fit_poses:
pixel selection, back-projection, batched RANSAC-Umeyama and the boxes),
by CUDA events around its call in eval/tester.py, ms per batch over the
spanned window; it includes the host's wait in its copy of the valid
masks to the CPU."""

SPANS = {"fit_poses": ("selfcorr_tpu_torch.eval.tester", "fit_poses")}


def read(ctx):
    times = ctx.spans.get("fit_poses", [])
    if not times or not ctx.units:
        return None
    return sum(times) / ctx.units
