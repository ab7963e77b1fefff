"""Pose / shape prediction heads (counterpart of
selfcorr_tpu/models/heads.py), named after the reference modules.

PosePredictor: rotation = fc stack 512->128 (3 layers, LeakyReLU 0.1) +
Linear->6, plus the per-category rotation_offset, through Gram-Schmidt;
translation = Linear->3 with xy * 0.1 and z + depth_offset; optional scale
head (* 0.1 + 1).

ShapeDeformer: [xyz || shape_code] -> layer1 -> layers_xyz.0 -> relu ->
relu(fc_feat) -> relu(layers_dir.0) -> fc_rgb. The reference applies no
activation between layer1 and layers_xyz.0; that quirk is kept. The delta
is mean-centred over vertices; pred_v = mean_v + delta * deform_ratio. The
MLP sees mean_v detached.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.ops.geometry import rot6d_to_matrix


class PosePredictor(nn.Module):
    def __init__(self, in_dim: int = 512,
                 rotation_offset: Sequence[float] = (0.0,) * 6,
                 depth_offset: float = 10.0, use_scale: bool = False):
        super().__init__()
        dims = [in_dim, 128, 128]
        fc_stack = nn.Sequential(*[
            nn.Sequential(nn.Linear(d, 128), nn.LeakyReLU(0.1)) for d in dims])
        self.rot_pred_layer = nn.Sequential(fc_stack, nn.Linear(128, 6))
        self.trans_pred_layer = nn.Linear(in_dim, 3)
        self.scale_pred_layer = nn.Linear(in_dim, 3) if use_scale else None
        self.rotation_offset_init = [float(v) for v in rotation_offset]
        self.register_buffer("rotation_offset", torch.tensor(
            self.rotation_offset_init, dtype=torch.float32),
            persistent=False)
        self.depth_offset = float(depth_offset)

    @torch.no_grad()
    def reset_parameters(self):
        """rotation_offset back to its value (models/init.py)."""
        self.rotation_offset.copy_(torch.tensor(self.rotation_offset_init))

    def forward(self, feat):  # (B, 512)
        rot6 = self.rot_pred_layer(feat) + self.rotation_offset
        rotation = rot6d_to_matrix(rot6)
        trans = self.trans_pred_layer(feat)
        trans = torch.cat([trans[:, :2] * 0.1,
                           trans[:, 2:] + self.depth_offset], -1)
        if self.scale_pred_layer is not None:
            scale = self.scale_pred_layer(feat) * 0.1 + 1.0
        else:
            scale = torch.ones((feat.shape[0], 3), dtype=feat.dtype,
                               device=feat.device)
        return rotation, trans, scale


class CondNeRF(nn.Module):
    def __init__(self, code_dim: int, hidden: int = 256):
        super().__init__()
        self.layer1 = nn.Linear(3 + code_dim, hidden)
        self.layers_xyz = nn.ModuleList([nn.Linear(hidden, hidden)])
        self.fc_feat = nn.Linear(hidden, hidden)
        self.layers_dir = nn.ModuleList([nn.Linear(hidden, hidden // 2)])
        self.fc_rgb = nn.Linear(hidden // 2, 3)

    def forward(self, x):
        x = self.layer1(x)  # no activation here (reference quirk)
        x = F.relu(self.layers_xyz[0](x))
        feat = F.relu(self.fc_feat(x))
        return self.fc_rgb(F.relu(self.layers_dir[0](feat)))


class ShapeDeformer(nn.Module):
    def __init__(self, code_dim: int = 64, hidden: int = 256,
                 deform_ratio: float = 1.0, no_deform: bool = False):
        super().__init__()
        self.deform_ratio = deform_ratio
        self.shapenerf = None if no_deform else CondNeRF(code_dim, hidden)

    def forward(self, mean_v, shape_code):
        """mean_v (B, N, 3); shape_code (B, code_dim) -> pred_v (B, N, 3)."""
        if self.shapenerf is None:
            return mean_v
        n = mean_v.shape[1]
        code = shape_code[:, None, :].expand(-1, n, -1)
        delta = self.shapenerf(torch.cat([mean_v.detach(), code], -1))
        delta = delta - delta.mean(dim=1, keepdim=True)
        return mean_v + delta * self.deform_ratio
