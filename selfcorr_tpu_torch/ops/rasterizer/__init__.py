"""Fused soft rasterizer, forward (the port of selfcorr_tpu/ops/rasterizer).

  common.py     constants, pixel grid, per-face constant packing
  reference.py  plain PyTorch fused forward (CPU path, on-card oracle)
  kernel.py     build + launch of the CUDA kernel csrc/raster_fwd.cu
  api.py        render_fused(): kernel on CUDA tensors, plain on CPU
"""
from selfcorr_tpu_torch.ops.rasterizer.api import (  # noqa: F401
    raster_fused_fwd,
    render_fused,
)
