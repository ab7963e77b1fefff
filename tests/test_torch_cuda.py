"""Tests of the port that need a CUDA card: the fused-rasterizer kernel
against its plain PyTorch version, and the predict path on the card against
the same path on the CPU. They skip without a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; tests/conftest.py imports JAX, so skip it there:

  python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import copy
import os

import numpy as np
import pytest
import torch

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.loader import TestLoader
from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
from selfcorr_tpu_torch.ops.rasterizer import api, common as C, kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import (
    PLANES, raster_fused_fwd_plain)
from selfcorr_tpu_torch.utils.device import set_fp32_precision

# kernel vs plain, absolute: the on-chip gate's bounds of the JAX package
# (alpha 2e-3, tex / match 3.8e-3, depth 1.4e-2); softmax maxima 1e-4;
# softmax sums 1e-3 relative to max(1, |s|)
ATOL = {"alpha1": 2e-3, "alpha2": 2e-3, "depth": 1.4e-2,
        "texr": 3.8e-3, "texg": 3.8e-3, "texb": 3.8e-3,
        "matr": 3.8e-3, "matg": 3.8e-3, "matb": 3.8e-3,
        "m_d": 1e-4, "m_t": 1e-4}
S_RTOL = 1e-3

SMALL = dict(dataset_name="synthetic", img_size=32, corr_h=8, corr_w=8,
             subdivide=1, batch_size=4, repeat=1, symmetry_idx=0,
             use_depth=True, n_corr_feat=16, codedim=8, depth_offset=5.0,
             eval=True, eval_nocs=True, dframe_eval=3,
             pose_fit_max_points=512, ransac_iters=8, num_workers=2,
             train=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    set_fp32_precision()
    return torch.device("cuda")


def make_scene(seed, b, n_faces, size=0.7, z0=5.0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.5, 0.5, (b, n_faces, 1, 2))
    tri = rng.uniform(-size / 2, size / 2, (b, n_faces, 3, 2))
    xy = np.clip(centers + tri, -0.95, 0.95)
    z = z0 + rng.uniform(-1.0, 1.0, (b, n_faces, 3, 1))
    fv = np.concatenate([xy, z], axis=-1).astype(np.float32)
    return [torch.tensor(a) for a in
            (fv, rng.rand(b, n_faces, 3, 3).astype(np.float32),
             rng.rand(b, n_faces, 3, 3).astype(np.float32))]


@pytest.mark.parametrize("s", [37, 48])
@pytest.mark.parametrize("gamma_t", [1e-2, 1e-4])
def test_kernel_matches_plain(cuda, gamma_t, s):
    consts = C.pack_constants(*make_scene(7, 3, 300)).to(cuda)
    before = kernel.LAUNCHES["raster_fused_fwd"]
    got = api.raster_fused_fwd(consts, s, gamma_t=gamma_t)
    assert kernel.LAUNCHES["raster_fused_fwd"] == before + 1
    ref = raster_fused_fwd_plain(consts, s, 1e-4, 1e-3, 1e-4, gamma_t)
    torch.cuda.synchronize()
    for n in PLANES:
        assert torch.isfinite(got[n]).all(), n
        err = (got[n] - ref[n]).abs()
        if n in ("s_d", "s_t"):
            err = err / ref[n].abs().clamp(min=1.0)
            assert float(err.max()) <= S_RTOL, n
        else:
            assert float(err.max()) <= ATOL[n], n


def test_kernel_refuses_what_it_does_not_take(cuda):
    consts = C.pack_constants(*make_scene(1, 1, 4)).to(cuda)
    with pytest.raises(ValueError, match="float32"):
        kernel.raster_fused_fwd_cuda(consts.double(), 16, 1e-4, 1e-3,
                                     1e-4, 1e-2)
    with pytest.raises(ValueError, match="float32"):
        kernel.raster_fused_fwd_cuda(consts[..., :32], 16, 1e-4, 1e-3,
                                     1e-4, 1e-2)


def test_predict_on_card_matches_cpu(cuda, tmp_path):
    """Tester.test() on the card renders its panels through the kernel; one
    batch predicted on the card and on the CPU, same weights and draws,
    agrees within 1e-3."""
    vis = tmp_path / "vis"
    cfg = Config(device="cuda", checkpoint_dir=str(tmp_path), name="gpu",
                 vis_pred=True, visualize_mask=True, visualize_tex=True,
                 visualize_depth=True, vis_path=str(vis), **SMALL)
    kernel.reset_launches()
    results = Tester(cfg).test()
    assert kernel.LAUNCHES["raster_fused_fwd"] == 2 * results["count"]
    assert all(np.isfinite(results[k]) for k in ("iou@25", "iou@50",
                                                 "5deg2cm", "10deg5cm"))
    assert len(os.listdir(vis)) == 3 * results["count"]

    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    gpu = Tester(cfg.replace(vis_pred=False))
    cpu = Tester(cfg.replace(vis_pred=False, device="cpu"),
                 model=copy.deepcopy(gpu.model))
    jitter = torch.tensor([1.1, 0.9, 1.05, 0.02])
    pg, fg = gpu.predict_batch(batch, jitter=jitter)
    pc, fc = cpu.predict_batch(batch, jitter=jitter)
    for k in ("pred_v", "tex", "match", "match_conf", "rotation",
              "translation"):
        torch.testing.assert_close(pg[k].cpu(), pc[k], atol=1e-3, rtol=0)
    for k in ("bbox9", "verts"):
        torch.testing.assert_close(fg[k].cpu(), fc[k], atol=1e-3, rtol=0)
