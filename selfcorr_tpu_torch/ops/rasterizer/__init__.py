"""Fused soft rasterizer, forward and backward (the port of
selfcorr_tpu/ops/rasterizer).

  common.py     constants, pixel grid, per-face constant packing
  reference.py  plain PyTorch fused forward and backward (CPU path,
                on-card oracle)
  kernel.py     build + launch of the CUDA kernels csrc/raster_fwd.cu and
                csrc/raster_bwd.cu
  api.py        RasterFused, render_fused(): kernels on CUDA tensors, plain
                versions on CPU tensors
"""
from selfcorr_tpu_torch.ops.rasterizer.api import (  # noqa: F401
    raster_fused_fwd,
    render_fused,
)
