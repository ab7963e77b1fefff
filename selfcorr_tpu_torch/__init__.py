"""selfcorr_tpu_torch — the PyTorch/CUDA port of `selfcorr_tpu`.

A second package beside the JAX one. It mirrors `selfcorr_tpu`'s module
names so each piece has an obvious counterpart, imports nothing of it, and
keeps its layout conventions at module boundaries (NHWC images, row-vector
transforms `v @ R + t`, WXYZ quaternions, NDC intrinsics) so parity tests
need no transposes.

The port runs the predict path (configs -> data -> MeshNet forward_test
-> RANSAC-Umeyama pose fit -> NOCS metrics, plus the full-frame render
panels) and the training step (forward_train with every loss, the frozen
DINO trunk, clipping, the NaN guard, five-group AdamW) behind a trainer
loop. The three TPU kernels on those paths are hand-written CUDA kernels
on CUDA tensors and plain PyTorch versions on CPU tensors: the fused
soft-rasterizer forward (ops/rasterizer/csrc/raster_fwd.cu) and backward
(csrc/raster_bwd.cu), and the DINO flash attention (ops/csrc/
flash_attn.cu).

Layering:
  ops/     geometry, mesh ops, knn, image resampling, Umeyama/RANSAC,
           attention (plain + kernel), the fused rasterizer (plain
           versions + kernels, autograd function)
  models/  nn.Modules: ResNet18+FPN, PointNet, pose/shape heads, DINO
           ViT-S/8, correspondence and cycle losses, MeshNet composition
           + forward_train / forward_test
  losses/  render, match and regularizer losses
  train/   optimizer, train state + step, trainer loop and entry point
  eval/    pose fitting, exact 3D IoU, NOCS metrics, Tester
  data/    cv2-free crops, synthetic videos, train and test loaders
  utils/   JAX-parameter import, CUDA build, PNG writer
"""

__version__ = "0.1.0"
