"""Scalar logging and the config snapshot (counterpart of
selfcorr_tpu/utils/logging.py).

make_writer gives torch.utils.tensorboard's SummaryWriter, or a NoopWriter
when tensorboard is not installed. TAGS groups the metrics as the JAX
package (and the reference trainer) does.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping


class NoopWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def make_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return NoopWriter()
    return SummaryWriter(log_dir)


# metric -> TensorBoard tag (selfcorr_tpu/utils/logging.py:36)
TAGS = {
    "total_loss": "total_loss/total_loss",
    "mask_loss": "render_loss/mask_loss",
    "texture_loss": "render_loss/texture_loss",
    "depth_loss": "render_loss/depth_loss",
    "match_loss": "correspondence/match_loss",
    "imatch_loss": "correspondence/imatch_loss",
    "cycle_loss": "correspondence/cycle_loss",
    "cycle_loss_pretrain": "correspondence/cycle_loss_pretrain",
    "triangle_loss": "regularization/triangle_loss",
    "deform_loss": "regularization/deform_loss",
    "symmetry_loss": "regularization/symmetry_loss",
    "pullfar_loss": "regularization/pullfar_loss",
    "cam_loss": "regularization/cam_loss",
    "grad_meanv_norm": "norms/grad_meanv_norm",
    "grad_shapenerf_norm": "norms/grad_shapenerf_norm",
    "grad_pose_predictor_norm": "norms/grad_pose_predictor_norm",
    "bad_grad": "norms/bad_grad",
}


def log_metrics(writer, metrics: Mapping[str, float], step: int) -> None:
    for k, v in metrics.items():
        writer.add_scalar(TAGS.get(k, k), float(v), step)


def write_config_snapshot(run_dir: str, cfg, filename: str = "config.txt"):
    """Every field of cfg as a `--name=value` line, sorted by name."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, filename), "w") as f:
        for k, v in sorted(dataclasses.asdict(cfg).items()):
            f.write(f"--{k}={v}\n")
