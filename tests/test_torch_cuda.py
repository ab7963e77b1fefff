"""Tests of the port that need a CUDA card: the fused-rasterizer kernels,
forward and backward in the compact schedule (B1, B2) and the dense-chunk
schedule (B1', B2'), with and without surface texels, and the DINO
attention kernel (B3) against their plain PyTorch versions, the predict path
on the card against the same path on the CPU, one full-width train step
on the card (laptop and bottle), a resume from a checkpoint on the card,
the chamfers' nearest-point search (B4) against a float64 brute force, the
CUB
evaluation's mask render on a batch read from a Wild6D fixture, and the
trainer's image-log forward (forward_vis) on the card against the CPU.
They skip without a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; tests/conftest.py imports JAX, so skip it there:

  python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import contextlib
import copy
import os

import numpy as np
import pytest
import torch

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.loader import TestLoader
from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
from selfcorr_tpu_torch.ops import attention as A, knn
from selfcorr_tpu_torch.ops.rasterizer import api, common as C, kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import (
    BWD_GRADS, PLANES, raster_fused_bwd_chunk_plain, raster_fused_bwd_plain,
    raster_fused_fwd_chunk_plain, raster_fused_fwd_plain)
from selfcorr_tpu_torch.utils.device import set_fp32_precision
from test_torch_threads import share_cores  # noqa: F401 (autouse)

# kernel vs plain, absolute: the on-chip gate's bounds of the JAX package
# (alpha 2e-3, tex / match 3.8e-3, depth 1.4e-2); softmax maxima 1e-4;
# softmax sums 1e-3 relative to max(1, |s|)
ATOL = {"alpha1": 2e-3, "alpha2": 2e-3, "depth": 1.4e-2,
        "texr": 3.8e-3, "texg": 3.8e-3, "texb": 3.8e-3,
        "matr": 3.8e-3, "matg": 3.8e-3, "matb": 3.8e-3,
        "m_d": 1e-4, "m_t": 1e-4}
S_RTOL = 1e-3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    with pytest.raises(ValueError, match="tex_res"):
        kernel.raster_fused_fwd_cuda(consts, 16, 1e-4, 1e-3, 1e-4, 1e-2, 2)
    spans, masks = api.chunk_info(consts, 16, 1e-4, 1e-3)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernel.raster_fused_fwd_chunk_cuda(consts[:, :8], spans, masks, 16,
                                           1e-4, 1e-3, 1e-4, 1e-2)
    with pytest.raises(ValueError, match="spans"):
        kernel.raster_fused_fwd_chunk_cuda(consts, spans[:, :2], masks, 16,
                                           1e-4, 1e-3, 1e-4, 1e-2)


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
    assert len(os.listdir(vis)) == 4 * results["count"]   # frame + 3 renders

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


def test_backward_kernel_matches_plain_and_repeats_bitwise(cuda):
    """B2 against its plain version, every slot within 1e-4 of the slot's
    largest value (the same per-pair arithmetic at -fmad=false; only the
    order of the per-face sums differs), and a second launch identical."""
    sg = (1e-4, 1e-3, 1e-4, 1e-2)
    consts = C.pack_constants(*make_scene(9, 3, 300)).to(cuda)
    planes = raster_fused_fwd_plain(consts, 48, *sg)
    g = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(3, 48, 48, generator=g).to(cuda)
             for n in BWD_GRADS}
    before = kernel.LAUNCHES["raster_fused_bwd"]
    got = api.raster_fused_bwd(consts, planes, grads, 48, *sg)
    again = kernel.raster_fused_bwd_cuda(consts, planes, grads, 48, *sg)
    assert kernel.LAUNCHES["raster_fused_bwd"] == before + 2
    ref = raster_fused_bwd_plain(consts, planes, grads, 48, *sg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    lim = 1e-4 * ref.abs().amax(dim=(0, 1))
    assert bool(((got - ref).abs() <= lim).all())


@pytest.mark.parametrize("t,tail", [(1, False), (65, False), (129, False),
                                    (1025, False), (1025, True)])
def test_attention_kernel_matches_plain(cuda, t, tail):
    """B3 against its plain version on strided views of one qkv tensor:
    within 2^-7 |plain| + 2^-12 max|v| (an output one bf16 ulp apart; the
    floor for a p one bf16 ulp apart). With `tail`, q >= 0 and k <= 0, so
    every real score is far below the 0 that an unmasked zero padding key
    of the last tile would score."""
    g = torch.Generator(device=cuda).manual_seed(t)
    qkv = torch.randn((2, t, 3, 6, 64), generator=g, device=cuda)
    if tail:
        qkv[:, :, 0] = qkv[:, :, 0].abs()
        qkv[:, :, 1] = -qkv[:, :, 1].abs()
    qkv = qkv.bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = A.LAUNCHES["dino_flash_attn"]
    got = A.attention(q, k, v)
    assert A.LAUNCHES["dino_flash_attn"] == before + 1
    ref = A.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    lim = 2.0 ** -7 * ref.float().abs() + 2.0 ** -12 * float(
        v.float().abs().max())
    assert bool(((got.float() - ref.float()).abs() <= lim).all())
    with pytest.raises(ValueError, match="CPU reference"):
        A.attention(q.float(), k.float(), v.float())


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("t", [127, 128, 129, 144, 145, 191, 192, 193, 257,
                               385])
def test_attention_kernel_at_tile_boundaries(cuda, t, contiguous):
    """B3 on both sides of its 192-row query tiles, its 128-key tiles and
    its short last key tile (at most 16 keys), on the trunk's strided views
    and on contiguous tensors, "tail" inputs (every real score far below the
    0 of an unmasked zero padding key): within 2^-7 |plain| + 2^-12
    max|v|."""
    g = torch.Generator(device=cuda).manual_seed(t)
    qkv = torch.randn((2, t, 3, 6, 64), generator=g, device=cuda)
    qkv[:, :, 0] = qkv[:, :, 0].abs()
    qkv[:, :, 1] = -qkv[:, :, 1].abs()
    qkv = qkv.bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if contiguous:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    got = A.flash_attention_cuda(q, k, v)
    ref = A.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    lim = 2.0 ** -7 * ref.float().abs() + 2.0 ** -12 * float(
        v.float().abs().max())
    assert bool(((got.float() - ref.float()).abs() <= lim).all())


@pytest.mark.parametrize("tex_res", [0, 6])
def test_backward_kernel_small_faces_repeat_bitwise(cuda, tex_res):
    """B2 where each face covers fewer than 32 pixels, so every warp's only
    batch of covered pixels is partly empty: within 1e-4 of each slot's
    largest plain value, and a second launch identical."""
    sg = (1e-4, 1e-3, 1e-4, 1e-2)
    s, n_faces = 40, 60
    fv, st, ht = make_scene(11, 2, n_faces, size=0.04)
    g = torch.Generator().manual_seed(tex_res)
    tex = torch.rand((2, n_faces, tex_res * tex_res, 3), generator=g) \
        if tex_res else None
    consts = C.pack_constants(fv, st, ht, surf_tex=tex).to(cuda)
    pairs = {}
    planes = raster_fused_fwd_plain(consts, s, *sg, tex_res,
                                    pair_counts=pairs)
    assert 0 < pairs["cover"] < 32 * 2 * n_faces
    grads = {n: torch.randn(2, s, s, generator=g).to(cuda) for n in BWD_GRADS}
    got = kernel.raster_fused_bwd_cuda(consts, planes, grads, s, *sg, tex_res)
    again = kernel.raster_fused_bwd_cuda(consts, planes, grads, s, *sg,
                                         tex_res)
    ref = raster_fused_bwd_plain(consts, planes, grads, s, *sg, tex_res)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    lim = 1e-4 * ref.abs().amax(dim=(0, 1))
    assert bool(((got - ref).abs() <= lim).all())
    assert float(got.abs().max()) > 0


def test_full_width_train_step_on_card(cuda, tmp_path):
    """One train step at Wild6D-laptop width (img 256, batch 8 x 4, laptop
    prior) on the card: finite metrics, and each kernel launched."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.data.loader import stack_items
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.train.loop import Trainer, make_train_dataset
    from selfcorr_tpu_torch.train.step import train_step
    cfg = parse_args(["--flagfile", os.path.join(ROOT, "config/wild6d/"
                                                 "laptop.txt"),
                      "--dataset_name", "synthetic",
                      "--checkpoint_dir", str(tmp_path)])
    trainer = Trainer(cfg)
    ds = make_train_dataset(cfg)
    batch = trainer.upload(stack_items([ds.load_item(*a)
                                        for a in ds.sample_plan(0)]))
    draws = draw_step(torch.Generator().manual_seed(0), cfg, 32)
    kernel.reset_launches()
    A.reset_launches()
    metrics = train_step(trainer.state, batch, draws, cfg)
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert float(metrics["bad_grad"]) == 0.0 and trainer.state.step == 1
    assert kernel.LAUNCHES == {"raster_fused_fwd": 1, "raster_fused_bwd": 1,
                               "raster_fused_fwd_chunk": 0,
                               "raster_fused_bwd_chunk": 0}
    assert A.LAUNCHES == {"dino_flash_attn": 9}


def test_full_width_bottle_train_step_launches_b4_once(cuda, tmp_path):
    """One train step at Wild6D-bottle width (the 17-fold symmetry
    chamfer): finite metrics, B4 launched once for the symmetry loss, and
    B1 / B2 / B3 as in the laptop's step."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.data.loader import stack_items
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.train.loop import Trainer, make_train_dataset
    from selfcorr_tpu_torch.train.step import train_step
    cfg = parse_args(["--flagfile", os.path.join(ROOT, "config/wild6d/"
                                                 "bottle.txt"),
                      "--dataset_name", "synthetic",
                      "--checkpoint_dir", str(tmp_path)])
    trainer = Trainer(cfg)
    ds = make_train_dataset(cfg)
    batch = trainer.upload(stack_items([ds.load_item(*a)
                                        for a in ds.sample_plan(0)]))
    draws = draw_step(torch.Generator().manual_seed(0), cfg, 32)
    kernel.reset_launches()
    A.reset_launches()
    knn.reset_launches()
    metrics = train_step(trainer.state, batch, draws, cfg)
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert float(metrics["bad_grad"]) == 0.0 and trainer.state.step == 1
    assert knn.LAUNCHES == {"nearest_point": 1}
    assert kernel.LAUNCHES == {"raster_fused_fwd": 1, "raster_fused_bwd": 1,
                               "raster_fused_fwd_chunk": 0,
                               "raster_fused_bwd_chunk": 0}
    assert A.LAUNCHES == {"dino_flash_attn": 9}


def brute_force_sq_dist(x, y, y_valid=None):
    """(B, N, M) float64 squared distances of the fp32 points, masked
    targets at +inf, one batch element at a time."""
    out = []
    for i in range(x.shape[0]):
        d = ((x[i].double()[:, None, :] - y[i].double()[None, :, :]) ** 2
             ).sum(-1)
        if y_valid is not None:
            d = torch.where(y_valid[i][None, :] > 0, d, float("inf"))
        out.append(d)
    return torch.stack(out)


def assert_nearest(idx, x, y, y_valid=None):
    """Each winner's float64 distance is within fp32 rounding of the
    float64 minimum: B4 sums three fp32 squares of fp32 differences, each
    within 2^-24 of its value, so a winner's exact distance is at most
    ~6 * 2^-23 above the least one, relatively; a masked target wins only
    where every target is masked, and then index 0."""
    assert idx.dtype == torch.int64 and idx.shape == x.shape[:2]
    assert bool(((idx >= 0) & (idx < y.shape[1])).all())
    for i in range(x.shape[0]):
        d = brute_force_sq_dist(x[i:i + 1], y[i:i + 1], None if y_valid
                                is None else y_valid[i:i + 1])[0]
        dmin = d.min(-1).values
        dwin = torch.gather(d, 1, idx[i][:, None])[:, 0]
        live = torch.isfinite(dmin)
        assert bool((dwin[live] <= dmin[live] * (1 + 1e-6) + 1e-30).all())
        assert bool((idx[i][~live] == 0).all())


def chamfer_points(b, n, m, seed, cuda):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, n, 3), generator=g, device=cuda) * 0.3
    y = torch.randn((b, m, 3), generator=g, device=cuda) * 0.3
    return x, y


# the bottle's and the laptop's symmetry chamfer (B, k * V, 10000 samples),
# the depth chamfer (B, 256 * 256, 2000), and ragged sizes about B4's
# 512-query blocks, 1024-target tiles and 8-target groups
B4_SHAPES = [(32, 17 * 614, 10000), (32, 2 * 592, 10000),
             (32, 256 * 256, 2000), (2, 1, 1), (3, 37, 1), (2, 513, 9),
             (2, 1000, 1025), (1, 5, 2049), (3, 1531, 3000)]


@pytest.mark.parametrize("b,n,m", B4_SHAPES)
def test_nearest_point_kernel_against_float64(cuda, b, n, m):
    x, y = chamfer_points(b, n, m, 11, cuda)
    before = knn.LAUNCHES["nearest_point"]
    idx = knn.nearest_index(x, y)
    assert knn.LAUNCHES["nearest_point"] == before + 1
    assert_nearest(idx, x, y)
    assert torch.equal(knn.nearest_index(x, y), idx)


@pytest.mark.parametrize("b,n,m", [(2, 700, 3000), (3, 37, 9), (2, 50, 1)])
def test_nearest_point_kernel_with_a_mask(cuda, b, n, m):
    """Masked targets never win; a batch element with every target masked
    answers index 0, as argmin over +inf does."""
    x, y = chamfer_points(b, n, m, 12, cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    valid = (torch.rand((b, m), generator=g, device=cuda) > 0.6).float()
    valid[-1] = 0.0
    idx = knn.nearest_index(x, y, valid.bool())
    assert_nearest(idx, x, y, valid)
    assert torch.equal(idx, knn.nearest_index(x, y, valid))
    assert bool((idx[-1] == 0).all())


@pytest.mark.parametrize("b,n,m", [(2, 700, 10000), (32, 1184, 10000),
                                   (2, 300, 17)])
def test_nearest_point_kernel_ties_go_to_the_first_index(cuda, b, n, m):
    """Exact duplicates planted (a) in the next slot, inside one 8-target
    group, and (b) half the targets later, across chunks when the targets
    are split: every winner is the first of its copies."""
    x, y = chamfer_points(b, n, m, 14, cuda)
    y[:, 1::2] = y[:, 0:(m // 2) * 2:2]
    idx = knn.nearest_index(x, y)
    assert bool((idx % 2 == 0).all())
    assert_nearest(idx, x, y)
    h = m // 2
    y2 = torch.cat([y[:, :h], y[:, :h]], 1)
    idx = knn.nearest_index(x, y2)
    assert bool((idx < h).all())
    assert torch.equal(idx, knn.nearest_index(x, y2))


def test_nearest_point_gradient_equals_the_plain_version(cuda):
    """min_sq_dist's gradients through B4's winners against those through
    the plain version's: equal for every query whose winner agrees, and
    for every target that no disagreeing query chose."""
    x, y = chamfer_points(4, 900, 1500, 15, cuda)
    idx_k = knn.nearest_index(x, y)
    idx_p = knn.nearest_index_plain(x, y)
    grads = []
    for idx in (idx_k, idx_p):
        xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(
            True)
        ynn = torch.gather(yg, 1, idx[..., None].expand(-1, -1, 3))
        ((xg - ynn) ** 2).sum(-1).clamp(min=0.0).sum().backward()
        grads.append((xg.grad, yg.grad))
    xk = x.clone().requires_grad_(True)
    yk = y.clone().requires_grad_(True)
    knn.min_sq_dist(xk, yk).sum().backward()
    assert torch.equal(xk.grad, grads[0][0])
    same = idx_k == idx_p
    assert float(same.float().mean()) > 0.99
    assert torch.equal(xk.grad[same], grads[1][0][same])
    touched = torch.zeros(y.shape[:2], dtype=torch.bool, device=cuda)
    for i in range(x.shape[0]):
        touched[i, idx_k[i][~same[i]]] = True
        touched[i, idx_p[i][~same[i]]] = True
    torch.testing.assert_close(yk.grad[~touched], grads[1][1][~touched],
                               rtol=1e-6, atol=1e-7)


def assert_fwd_close(got, ref):
    for n in PLANES:
        assert torch.isfinite(got[n]).all(), n
        err = (got[n] - ref[n]).abs()
        if n in ("s_d", "s_t"):
            err = err / ref[n].abs().clamp(min=1.0)
            assert float(err.max()) <= S_RTOL, n
        else:
            assert float(err.max()) <= ATOL[n], n


def surface_consts(cuda, seed, b, nf, res, s):
    fv, st, ht = make_scene(seed, b, nf)
    g = torch.Generator().manual_seed(seed)
    tex = torch.rand((b, nf, res * res, 3), generator=g) if res else None
    return C.pack_constants(fv, st, ht, surf_tex=tex,
                            n_bands=C.bands_for(s)).to(cuda)


@pytest.mark.parametrize("tex_res", [0, 6])
@pytest.mark.parametrize("s", [48, 64])
def test_chunk_forward_kernel_matches_plain_and_b1(cuda, s, tex_res):
    """B1' against its plain version at the B1 gates, and against B1 on the
    same sorted constants: the two walk the faces in one order and skip
    only pairs that cover nothing, so they agree bit for bit."""
    consts = surface_consts(cuda, 7, 3, 300, tex_res, s)
    spans, masks = api.chunk_info(consts, s, 1e-4, 1e-3)
    before = dict(kernel.LAUNCHES)
    got = api.raster_fused_fwd(consts, s, tex_res=tex_res,
                               chunks=(spans, masks))
    b1 = api.raster_fused_fwd(consts, s, tex_res=tex_res)
    assert kernel.LAUNCHES["raster_fused_fwd_chunk"] == \
        before["raster_fused_fwd_chunk"] + 1
    ref = raster_fused_fwd_chunk_plain(consts, spans, masks, s, 1e-4, 1e-3,
                                       1e-4, 1e-2, tex_res)
    torch.cuda.synchronize()
    assert_fwd_close(got, ref)
    assert_fwd_close(b1, raster_fused_fwd_plain(consts, s, 1e-4, 1e-3, 1e-4,
                                                1e-2, tex_res))
    for n in PLANES:
        assert torch.equal(got[n], b1[n]), n


@pytest.mark.parametrize("tex_res", [0, 6])
def test_chunk_backward_kernel_matches_plain_and_repeats_bitwise(cuda,
                                                                 tex_res):
    """B2' (and B2 with texels) against the plain versions, every slot
    within 1e-4 of the slot's largest value, and a second launch
    identical."""
    sg = (1e-4, 1e-3, 1e-4, 1e-2)
    s = 64
    consts = surface_consts(cuda, 9, 3, 300, tex_res, s)
    spans, masks = api.chunk_info(consts, s, 1e-4, 1e-3)
    planes = raster_fused_fwd_plain(consts, s, *sg, tex_res)
    g = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(3, s, s, generator=g).to(cuda)
             for n in BWD_GRADS}
    before = kernel.LAUNCHES["raster_fused_bwd_chunk"]
    got = api.raster_fused_bwd(consts, planes, grads, s, *sg, tex_res,
                               chunks=(spans, masks))
    again = kernel.raster_fused_bwd_chunk_cuda(consts, spans, masks, planes,
                                               grads, s, *sg, tex_res)
    assert kernel.LAUNCHES["raster_fused_bwd_chunk"] == before + 2
    ref = raster_fused_bwd_chunk_plain(consts, spans, masks, planes, grads,
                                       s, *sg, tex_res)
    b2 = kernel.raster_fused_bwd_cuda(consts, planes, grads, s, *sg, tex_res)
    b2_ref = raster_fused_bwd_plain(consts, planes, grads, s, *sg, tex_res)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    for k, r in ((got, ref), (b2, b2_ref)):
        lim = 1e-4 * r.abs().amax(dim=(0, 1))
        assert bool(((k - r).abs() <= lim).all())
    if tex_res:
        assert float(got[..., C.S_SURF:].abs().max()) > 0


@pytest.mark.parametrize("tex_res", [0, 6])
@pytest.mark.parametrize("b,s", [(1, 320), (2, 40), (2, 72)])
def test_forward_kernel_sub_tiles(cuda, b, s, tex_res):
    """B1 at the predict panels' B = 1, S = 320 and at ragged S that no
    block divides, with and without texels: within the gates against the
    plain version, and a second launch bit-identical."""
    consts = surface_consts(cuda, 11 + s, b, 300, tex_res, s)
    sg = (1e-4, 1e-3, 1e-4, 1e-2)
    got = kernel.raster_fused_fwd_cuda(consts, s, *sg, tex_res)
    again = kernel.raster_fused_fwd_cuda(consts, s, *sg, tex_res)
    ref = raster_fused_fwd_plain(consts, s, *sg, tex_res)
    torch.cuda.synchronize()
    assert_fwd_close(got, ref)
    assert float(got["alpha1"].max()) > 0.5
    for n in PLANES:
        assert torch.equal(got[n], again[n]), n


@pytest.mark.parametrize("tex_res", [0, 6])
@pytest.mark.parametrize("s", [72, 256, 320])
def test_chunk_forward_equals_b1(cuda, s, tex_res):
    """B1' on its tiles (16 x 64 at S = 256 / 320, 8 x 72 at S = 72)
    equals B1 bit for bit on the same sorted constants, and holds the gates
    against its plain version."""
    consts = surface_consts(cuda, 13, 2, 600, tex_res, s)
    sg = (1e-4, 1e-3, 1e-4, 1e-2)
    spans, masks = api.chunk_info(consts, s, 1e-4, 1e-3)
    got = kernel.raster_fused_fwd_chunk_cuda(consts, spans, masks, s, *sg,
                                             tex_res)
    b1 = kernel.raster_fused_fwd_cuda(consts, s, *sg, tex_res)
    ref = raster_fused_fwd_chunk_plain(consts, spans, masks, s, *sg,
                                       tex_res)
    torch.cuda.synchronize()
    assert_fwd_close(got, ref)
    for n in PLANES:
        assert torch.equal(got[n], b1[n]), n


def bwd_inputs(cuda, seed, b, nf, tex_res, s):
    """Sorted constants, their chunk cull, the plain forward's planes and
    seeded cotangents at image size s."""
    sg = (1e-4, 1e-3, 1e-4, 1e-2)
    consts = surface_consts(cuda, seed, b, nf, tex_res, s)
    spans, masks = api.chunk_info(consts, s, 1e-4, 1e-3)
    planes = raster_fused_fwd_plain(consts, s, *sg, tex_res)
    g = torch.Generator().manual_seed(seed)
    grads = {n: torch.randn(b, s, s, generator=g).to(cuda)
             for n in BWD_GRADS}
    return consts, spans, masks, planes, grads, sg


@pytest.mark.parametrize("tex_res", [0, 6])
@pytest.mark.parametrize("s", [72, 256, 320])
def test_chunk_backward_equals_b2(cuda, s, tex_res):
    """B2' runs B2's kernel over the chunk cull, which keeps every covered
    pair of B2's boxes here: its queue is B2's, so on the same sorted
    constants, planes and cotangents the two agree bit for bit."""
    consts, spans, masks, planes, grads, sg = bwd_inputs(cuda, 13, 2, 600,
                                                         tex_res, s)
    got = kernel.raster_fused_bwd_chunk_cuda(consts, spans, masks, planes,
                                             grads, s, *sg, tex_res)
    b2 = kernel.raster_fused_bwd_cuda(consts, planes, grads, s, *sg,
                                      tex_res)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float(got.abs().max()) > 0
    assert torch.equal(got, b2)


@pytest.mark.parametrize("tex_res", [0, 6])
def test_chunk_backward_honours_cleared_bits(cuda, tex_res):
    """With every other tile's mask words cleared, B2' drops those tiles'
    pairs as the chunk plain version does on the same masks (every slot
    within 1e-4 of the slot's largest), and differs from B2."""
    s = 64
    consts, spans, masks, planes, grads, sg = bwd_inputs(cuda, 17, 2, 300,
                                                         tex_res, s)
    n_tiles = spans.shape[1] // 2
    cleared = masks.reshape(2, n_tiles, -1).clone()
    cleared[:, ::2] = 0
    cleared = cleared.reshape(masks.shape)
    got = kernel.raster_fused_bwd_chunk_cuda(consts, spans, cleared, planes,
                                             grads, s, *sg, tex_res)
    ref = raster_fused_bwd_chunk_plain(consts, spans, cleared, planes, grads,
                                       s, *sg, tex_res)
    b2 = kernel.raster_fused_bwd_cuda(consts, planes, grads, s, *sg,
                                      tex_res)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    lim = 1e-4 * ref.abs().amax(dim=(0, 1))
    assert bool(((got - ref).abs() <= lim).all())
    assert not torch.allclose(got, b2)


def test_resume_on_card(cuda, tmp_path):
    """The resume case of tests/test_torch_checkpoint.py on the card: the
    restored state equals the saved one bit for bit; the step after the
    resume equals the straight run's second step bit for bit where two runs
    of that step from one state agree bit for bit, and otherwise lies no
    further from it than they lie from each other (cuDNN's and the atomic
    scatters' sums need not repeat). The steps run with PyTorch's
    deterministic algorithms, which should make that noise zero."""
    from test_torch_checkpoint import (assert_equal_states, parse_args,
                                       state_tensors, straight_and_resumed,
                                       take_step, tiny_args)

    def forked_step(trainer):
        fork = copy.copy(trainer)
        fork.state = copy.deepcopy(trainer.state)
        m = take_step(fork, r["batches"][1], 1)
        return {**state_tensors(fork), **{f"metric.{k}": v.reshape(1)
                                          for k, v in m.items()}}

    def max_diff(x, y):
        return max(float((x[k].double() - y[k].double()).abs().max())
                   for k in x)

    with deterministic():
        r = straight_and_resumed(parse_args(tiny_args(tmp_path, "cuda")))
        noise = max_diff(forked_step(r["b0"]), forked_step(r["b0"]))
    assert r["a"].state.model.mesh.mean_v.is_cuda
    assert_equal_states(r["resumed"], r["saved"])
    got = {**state_tensors(r["b"]), **{f"metric.{k}": v.reshape(1)
                                       for k, v in r["mb"].items()}}
    want = {**state_tensors(r["a"]), **{f"metric.{k}": v.reshape(1)
                                        for k, v in r["ma"].items()}}
    err = max_diff(got, want)
    print(f"resumed vs straight step: max|diff| {err:.3g}; the step's own "
          f"noise {noise:.3g}")
    assert err == 0.0 if noise == 0.0 else err <= noise


def test_fitted_mask_render_on_wild6d_fixture(cuda, tmp_path):
    """The CUB evaluation's mask render (Tester.fitted_alpha) on a batch
    read from a Wild6D fixture: through B1 on the card, once, and through
    the plain version on the CPU from the same fit, alpha1 within 2e-3."""
    from selfcorr_tpu_torch.data import fixtures as FX
    train_root, test_root = FX.wild6d_tree(
        str(tmp_path / "w6d"), n_train_videos=1, n_test_videos=2,
        frames_per_video=2, test_frames=2, raw_size=96)
    FX.write_list(test_root, str(tmp_path / "test.txt"))
    cfg = Config(**dict(SMALL, dataset_name="Wild6D", dframe_eval=1),
                 test_dataset_path=test_root + "/",
                 test_list=str(tmp_path / "test.txt"), device="cuda",
                 checkpoint_dir=str(tmp_path))
    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    gpu = Tester(cfg)
    pred, fit = gpu.predict_batch(batch)
    kernel.reset_launches()
    got = gpu.fitted_alpha(batch, pred, fit)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["raster_fused_fwd"] == 1
    cpu = Tester(cfg.replace(device="cpu"), model=copy.deepcopy(gpu.model))
    ref = cpu.fitted_alpha(batch, {"faces": pred["faces"].cpu()},
                           {"verts": fit["verts"].cpu()})
    assert got.shape == ref.shape == (4, 32, 32)
    assert float(ref.max()) > 0.5
    assert float((got.cpu() - ref).abs().max()) <= ATOL["alpha1"]


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's too) inside the block;
    an op that has none warns and runs as it would."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def test_forward_vis_on_card_matches_cpu(cuda):
    """The trainer's image-log forward on the card (B1 twice at B = 2, B3
    in the bf16 trunk) against the same forward on the CPU (the plain
    versions), same weights, batch and draws: every product within 1e-3.
    The CPU forward takes the card's trunk features: the DINO pair panels
    pick mutual-argmax matches, which one bf16 rounding of B3 against its
    plain version (held in the B3 tests) may flip."""
    from selfcorr_tpu_torch.models.meshnet import (MeshNet,
                                                   build_mesh_constants,
                                                   forward_vis)
    from selfcorr_tpu_torch.models.vit import DinoViTS8
    cfg = Config(**{**SMALL, "batch_size": 2, "pretrain_k": 8,
                    "device": "cuda"})
    constants = build_mesh_constants(cfg)
    torch.manual_seed(0)
    model, dino = MeshNet(cfg, constants), DinoViTS8(img_size=32).eval()
    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = {k: torch.tensor(v) for k, v in next(iter(loader)).items()
             if k in ("img", "mask", "depth", "occ", "pp_crop", "foc_crop")}
    loader.close()
    draws = dict(jitter=torch.tensor([1.1, 0.9, 1.05, 0.02]),
                 angle=torch.tensor(37.0),
                 cycle_jitter=torch.tensor([0.95, 1.1, 0.9, -0.03]))
    dino_gpu = copy.deepcopy(dino).to(cuda)
    batch_gpu = {k: v.to(cuda) for k, v in batch.items()}
    kernel.reset_launches()
    A.reset_launches()
    gpu = forward_vis(copy.deepcopy(model).to(cuda), dino_gpu, batch_gpu,
                      constants, cfg, **draws)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["raster_fused_fwd"] == 2
    assert A.LAUNCHES["dino_flash_attn"] == 9
    with torch.no_grad():
        feats = dino_gpu(batch_gpu["img"][:2]).cpu()
    cpu = forward_vis(model, lambda img: feats, batch, constants, cfg,
                      **draws)
    for k, want in cpu.items():
        torch.testing.assert_close(gpu[k].cpu(), want, atol=1e-3, rtol=0,
                                   msg=k)


def test_bf16_trunk_on_card_runs_b3_and_matches_cpu(cuda):
    """A trunk cast to bfloat16 (--dino_bf16) with attn_bf16 off: its q, k,
    v are bf16 strided views of the qkv projection's bf16 output, so each
    of its 9 attention blocks launches B3; its features against the same
    trunk on the CPU (flash_attention_plain) within 2e-2 of their largest
    entry and 3e-3 in mean (bf16 roundings that the card's and the CPU's
    products place apart, compounded over 10 blocks)."""
    from selfcorr_tpu_torch.models.vit import DinoViTS8
    torch.manual_seed(0)
    cpu = DinoViTS8(img_size=64, attn_bf16=False).to(torch.bfloat16)
    card = copy.deepcopy(cpu).to(cuda)
    img = torch.rand((2, 64, 64, 3), generator=torch.Generator()
                     .manual_seed(1)).bfloat16()
    before = A.LAUNCHES["dino_flash_attn"]
    with torch.no_grad():
        got = card(img.to(cuda)).float().cpu()
        want = cpu(img).float()
    assert A.LAUNCHES["dino_flash_attn"] == before + 9
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-2 * scale
    assert float((got - want).abs().mean()) <= 3e-3 * scale


def silhouette(mask):
    """Pixels of a (B, H, W) bool mask with a pixel of the other value in
    their 3 x 3 neighbourhood."""
    m = mask.float()[:, None]
    pad = torch.nn.functional.pad(m, (1, 1, 1, 1), mode="replicate")
    lo = -torch.nn.functional.max_pool2d(-pad, 3, 1)
    hi = torch.nn.functional.max_pool2d(pad, 3, 1)
    return (lo != hi)[:, 0]


def test_device_generator_on_card_matches_cpu(cuda):
    """--synthetic_on_device's generator on the card against the CPU, given
    the same draws: the integer crop boxes equal; a mask pixel may differ
    only on the silhouette (a grazing ray whose discriminant rounds across
    0), and at most 0.1% of the pixels; where both masks agree, img within
    5e-3 and depth within 2 mm of ~6000 (2.31e-3 and 1 mm measured at the
    training path's width, chip_smoke.py phase 14: sin / cos and the
    grazing rays' hit distances round apart on the card)."""
    from selfcorr_tpu_torch.data import synthetic_device as SD
    from selfcorr_tpu_torch.data.synthetic import SyntheticVideos
    cfg = Config(dataset_name="synthetic", img_size=64, batch_size=4,
                 repeat=2, synthetic_shape="duo")
    videos = SyntheticVideos(seed=0, shape="duo")
    g = torch.Generator().manual_seed(5)
    vids = torch.randint(0, 4, (4,), generator=g)
    offs = torch.randint(0, 12, (4, 2), generator=g)
    scale = 1.2 + 0.3 * torch.rand((8, 2), generator=g)
    boxes = {}
    for dev in ("cpu", cuda):
        t = SD.video_tables(videos, dev)
        v = torch.repeat_interleave(vids, 2).to(dev)
        fids = torch.clamp(torch.arange(2)[None] * 12 + offs, max=23)
        theta = t["phase"][v] + 2.0 * np.pi * fids.reshape(-1).float().to(
            dev) / 24
        rot = SD.rot_mats(t["tilt"][v], theta)
        boxes[str(dev)] = [x.cpu() for x in SD.crop_bbox_analytic(
            t, v, rot, t["z0"][v], 320, 2)]
    assert all(torch.equal(a, b) for a, b in zip(*boxes.values()))
    want = SD.make_device_synth(cfg, videos, "cpu")(vids=vids, offs=offs,
                                                    scale=scale)
    got = {k: v.cpu() for k, v in SD.make_device_synth(cfg, videos, cuda)(
        vids=vids, offs=offs, scale=scale).items()}
    flips = got["mask"] != want["mask"]
    assert not bool((flips & ~silhouette(want["mask"] > 0)).any())
    assert float(flips.float().mean()) <= 1e-3
    same = ~flips
    assert float((got["img"] - want["img"]).abs()[same].max()) <= 5e-3
    assert float((got["depth"] - want["depth"]).abs()[same].max()) <= 2.0
    for k in ("foc_crop", "pp_crop"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
