"""ResNet-18 backbone + FPN-style decoder (counterpart of
selfcorr_tpu/models/resnet.py).

Module boundaries are NHWC like the JAX package's; the convolutions run in
NCHW inside. Parameter names follow torchvision's resnet18 and the
reference decoder (conv2DBatchNormRelu `cbr_unit.{0,1}`), the names
selfcorr_tpu/utils/weight_convert.py convert_meshnet reads, so a reference
checkpoint maps onto this module by a rename.

BatchNorm follows flax nn.BatchNorm (momentum 0.9, eps 1e-5): in train mode
it normalizes with the batch statistics and moves the running variance
toward the BIASED batch variance (torch's BatchNorm2d would use the unbiased
one); `frozen_stats` runs train-mode normalization without touching the
running statistics.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.ops.image_ops import resize_bilinear


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's train-mode running statistics: running =
    0.9 * running + 0.1 * batch, the batch variance biased (divided by n).
    Eval mode normalizes with the running statistics, as BatchNorm2d."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    var, alpha=self.momentum)
        return y


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Inside the block, train-mode BatchNorm layers of `module` normalize
    with the batch statistics but leave their running statistics alone."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in layers]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m, u in zip(layers, saved):
            m.update_stats = u


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm(cout))

    def forward(self, x):  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNet18(nn.Module):
    """(B, H, W, 3) -> pyramid (conv2, conv3, conv4, conv5), each NHWC,
    strides 4/8/16/32, channels 64/128/256/512."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, (cout, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                            (512, 2)]):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, cout, stride), BasicBlock(cout, cout, 1)))
            cin = cout

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(_nchw(x))))
        y = F.max_pool2d(y, 3, 2, 1)
        feats = []
        for i in range(4):
            y = getattr(self, f"layer{i + 1}")(y)
            feats.append(_nhwc(y))
        return tuple(feats)


class Backbone(nn.Module):
    """Holds the ResNet under `resnet`, the reference's nesting
    (encoder.backbone.resnet.*)."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()

    def forward(self, x):
        return self.resnet(x)


class ConvBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cbr_unit = nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1,
                                                bias=False),
                                      BatchNorm(cout))

    def forward(self, x):  # NHWC -> NHWC
        return _nhwc(F.relu(self.cbr_unit(_nchw(x))))


class FPNDecoder(nn.Module):
    """Up-path upconv(k+1) ++ conv(k) -> iconv(k); projects stride-4
    (downsample 4) or stride-8 features to out_channels. NHWC in and out."""

    def __init__(self, out_channels: int = 64, downsample: int = 4):
        super().__init__()
        self.downsample = downsample
        self.upconv5 = ConvBnRelu(512, 256)
        self.iconv4 = ConvBnRelu(256 + 256, 256)
        self.upconv4 = ConvBnRelu(256, 128)
        self.iconv3 = ConvBnRelu(128 + 128, 128)
        self.upconv3 = ConvBnRelu(128, 64)
        self.iconv2 = ConvBnRelu(64 + 64, 64)
        self.proj = nn.Conv2d(64 if downsample == 4 else 128, out_channels, 1)

    def forward(self, feats):
        conv2, conv3, conv4, conv5 = feats
        c5x = resize_bilinear(conv5, conv4.shape[1:3])
        c4 = self.iconv4(torch.cat([conv4, self.upconv5(c5x)], -1))
        c4x = resize_bilinear(c4, conv3.shape[1:3])
        c3 = self.iconv3(torch.cat([conv3, self.upconv4(c4x)], -1))
        if self.downsample == 4:
            c3x = resize_bilinear(c3, conv2.shape[1:3])
            top = self.iconv2(torch.cat([conv2, self.upconv3(c3x)], -1))
        else:
            top = c3
        return _nhwc(self.proj(_nchw(top)))
