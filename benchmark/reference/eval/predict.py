"""The reference's predict call: the port's Tester.predict_batch on one
rank, over the reference's plain modules (frozen copy): the host batch
uploaded, the eval forward (forward_test) with the given colour jitter,
then the whole-batch RANSAC-Umeyama pose fit with uniforms drawn on the
CPU from a generator seeded `ransac_seed`."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.eval.pose_fit import fit_poses
from benchmark.reference.models.meshnet import forward_test

BATCH_KEYS = ("img", "mask", "depth", "occ", "pp_crop", "foc_crop")


@torch.no_grad()
def predict_batch(model, constants, cfg, host_batch: dict, jitter,
                  ransac_seed: int, device) -> dict:
    """The fitted poses and boxes of one host batch: rotation (B, 3, 3),
    translation (B, 1, 3), scale_fit (B, 1, 1), bbox9 (B, 9, 3), ok (B,),
    as tensors on `device`."""
    tb = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
          for k, v in host_batch.items() if k in BATCH_KEYS}
    b = len(host_batch["img"])
    u = torch.rand((b, cfg.ransac_iters, 5),
                   generator=torch.Generator().manual_seed(ransac_seed))
    pred = forward_test(model, tb, constants, cfg, jitter=jitter)
    base_rot = torch.as_tensor(constants.base_rot, device=device)
    return fit_poses(pred["match"], pred["match_conf"], tb["depth"],
                     tb["mask"], tb["pp_crop"], tb["foc_crop"],
                     pred["pred_v"], base_rot,
                     max_points=cfg.pose_fit_max_points,
                     n_iters=cfg.ransac_iters, sample_u=u)
