"""selfcorr_tpu_torch — the PyTorch/CUDA port of `selfcorr_tpu`.

A second package beside the JAX one. It mirrors `selfcorr_tpu`'s module
names so each piece has an obvious counterpart, imports nothing of it, and
keeps its layout conventions at module boundaries (NHWC images, row-vector
transforms `v @ R + t`, WXYZ quaternions, NDC intrinsics) so parity tests
need no transposes.

This slice ports the predict path: configs -> data -> MeshNet forward_test
-> RANSAC-Umeyama pose fit -> NOCS metrics, plus the full-frame render
panels, whose fused soft-rasterizer forward is a hand-written CUDA kernel
(ops/rasterizer/csrc/raster_fwd.cu) on CUDA tensors and a plain PyTorch
version on CPU tensors.

Layering:
  ops/     geometry, mesh builders, image resampling, Umeyama/RANSAC,
           the fused rasterizer (plain version + CUDA kernel)
  models/  nn.Modules: ResNet18+FPN, PointNet, pose/shape heads,
           correspondence, MeshNet composition + forward_test
  eval/    pose fitting, exact 3D IoU, NOCS metrics, Tester
  data/    cv2-free crops, synthetic videos, test loader
  utils/   JAX-parameter import, PNG writer
"""

__version__ = "0.1.0"
