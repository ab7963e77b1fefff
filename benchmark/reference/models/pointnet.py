"""PointNet-style mesh vertex encoder (counterpart of
selfcorr_tpu/models/pointnet.py): a spatial transformer (shared per-point
3->128 + ReLU, max-pool, fc -> 3x3 + I) aligns the points, then a shared
per-point 3->n_feat + ReLU gives per-vertex features. Points are (B, N, C);
the per-point layers keep the reference's Conv1d(k=1) parameter shapes."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class PointConv(nn.Conv1d):
    """Conv1d(k=1) applied to (B, N, C_in) points -> (B, N, C_out)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return F.linear(x, self.weight[..., 0], self.bias)


class STN3d(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = PointConv(3, 128)
        self.fc = nn.Linear(128, 9)

    def forward(self, x):  # (B, N, 3) -> (B, 3, 3)
        y = F.relu(self.conv1(x)).amax(dim=1)
        m = self.fc(y) + torch.eye(3, device=x.device,
                                   dtype=x.dtype).reshape(9)
        return m.reshape(-1, 3, 3)


class MeshEncoder(nn.Module):
    def __init__(self, n_feat: int = 64):
        super().__init__()
        self.stn = STN3d()
        self.conv1 = PointConv(3, n_feat)

    def forward(self, x):  # (B, N, 3) -> (B, N, n_feat)
        x = torch.matmul(x, self.stn(x))
        return F.relu(self.conv1(x))
