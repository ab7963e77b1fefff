"""Training losses (counterpart of selfcorr_tpu/losses)."""
from selfcorr_tpu_torch.losses.match_losses import (  # noqa: F401
    DIVIDE_FNS,
    divide_by_both,
    divide_by_frame,
    divide_by_instance,
    imatch_loss,
    match_loss,
)
from selfcorr_tpu_torch.losses.regularizers import (  # noqa: F401
    camera_loss,
    deform_loss,
    flatten_loss,
    laplacian_loss,
    pullfar_loss,
    symmetry_loss,
)
from selfcorr_tpu_torch.losses.render_losses import (  # noqa: F401
    depth_loss,
    depth_loss_chamfer,
    mask_pyramid_loss,
    texture_loss,
)
