"""The port's CUB reader, its CUB metrics and its CUB evaluation against the
JAX package's, on the CPU.

Tolerances: reader items exact but the bilinear image plane (1e-5), as in
tests/test_torch_datasets.py; matrix_to_quat, mask_iou and map_kp within
1e-6; the evaluation's mIoU within 1e-3 and its PCK hits equal. Trees at
60 x 80 (the JAX helper's size) and 120 x 160, crops at img 32.
"""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from selfcorr_tpu.configs import Config as JConfig
from selfcorr_tpu.data import cub as JB
from selfcorr_tpu.eval import metrics as JMetrics
from selfcorr_tpu.eval.tester import Tester as JTester
from selfcorr_tpu.ops.geometry import matrix_to_quat as jax_matrix_to_quat
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data import cub as B
from selfcorr_tpu_torch.data import fixtures as FX
from selfcorr_tpu_torch.data.loader import TestLoader
from selfcorr_tpu_torch.eval import metrics as M
from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
from selfcorr_tpu_torch.ops.geometry import matrix_to_quat
from test_cub_dataset import make_cub_tree
from test_torch_datasets import assert_items_equal, same_draws

TINY = dict(img_size=32, corr_h=8, corr_w=8, subdivide=1, batch_size=4,
            repeat=1, n_corr_feat=16, codedim=8, pretrain_k=8,
            symmetry_npts=256, pose_fit_max_points=256, ransac_iters=8,
            depth_offset=5.0, num_workers=2, use_depth=False,
            symmetry_idx=-1, camera_loss=True)


def cub_tree(tmp_path, maker, split, per_class=3):
    root = str(tmp_path / f"cub_{maker}_{split}")
    if maker == "jax":
        os.makedirs(root)
        return root, make_cub_tree(root, per_class=per_class, split=split)
    return root, FX.cub_tree(root, per_class=per_class, hw=(120, 160),
                             split=split)


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_cub_items_match_jax(tmp_path, maker):
    """CUBTrain.load_item with the box jitter the JAX reader draws for
    itself, and every CUBTest item: kp and sfm_pose included."""
    root, lf = cub_tree(tmp_path, maker, "train")
    kw = dict(dataset_name="cub", dataset_path=root, train_list=lf,
              img_size=32, batch_size=2, repeat=2)
    ref, ours = JB.CUBTrain(JConfig(**kw)), B.CUBTrain(Config(**kw))
    assert ours.class_groups == ref.class_groups == [[0, 1, 2], [3, 4, 5]]
    for vid, fid in [(0, 1), (1, 2), (1, 0)]:
        r = same_draws(ref.rng)
        draws = np.array([r.random() for _ in range(4)])
        item = ours.load_item(vid, fid, draws)
        assert_items_equal(item, ref.load_item(vid, fid), f"{vid}/{fid}")
    assert np.abs(item["kp"][:, :2]).max() <= 1.0
    plan = ours.sample_plan(0)
    assert [len(p) for p in plan] == [3] * 4
    assert all(np.all((d >= 0) & (d < 1)) for _, _, d in plan)

    root, lf = cub_tree(tmp_path, maker, "test", per_class=2)
    kw = dict(dataset_name="cub", test_dataset_path=root, test_list=lf,
              img_size=32, dframe_eval=1)
    ref, ours = JB.CUBTest(JConfig(**kw)), B.CUBTest(Config(**kw))
    assert ours.samples == ref.samples and len(ours) == 4
    for i in range(len(ref)):
        assert_items_equal(ours.load_item(i), ref.load_item(i), f"test {i}")


def test_matrix_to_quat_matches_jax():
    """Every Shepperd branch: random rotations and rotations by about pi
    about each axis (where w is near 0 and the sign is decided)."""
    rng = np.random.RandomState(0)
    mats = [Rotation.random(24, random_state=rng).as_matrix()]
    for axis in np.eye(3):
        mats.append(Rotation.from_rotvec(
            np.outer([np.pi, np.pi - 1e-3, -np.pi + 1e-3], axis)).as_matrix())
    R = np.concatenate(mats).astype(np.float32)
    got = matrix_to_quat(torch.from_numpy(R)).numpy()
    want = np.asarray(jax_matrix_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[:, 0] >= 0).all()


def test_mask_iou_and_map_kp_match_jax():
    rng = np.random.RandomState(1)
    b, h, w, k = 3, 12, 16, 15
    m1, m2 = (rng.rand(2, b, h, w) > 0.4).astype(np.float32)
    np.testing.assert_allclose(M.mask_iou(m1, m2),
                               JMetrics.mask_iou(m1, m2), atol=1e-6, rtol=0)
    kps = np.concatenate([rng.uniform(-1, 1, (2, b, k, 2)),
                          (rng.rand(2, b, k, 1) > 0.3)], -1).astype(np.float32)
    vis = kps[..., 2]
    match = rng.uniform(-1, 1, (2, b, h, w, 3)).astype(np.float32)
    args = (vis[0], vis[1], kps[0], kps[1], match[0], match[1], m1, m2)
    for got, want in zip(M.map_kp(*args), JMetrics.map_kp(*args)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def cub_eval(tmp_path_factory):
    """The port's predict_batch on a CUB test batch, from seeded weights."""
    d = tmp_path_factory.mktemp("cubev")
    root, lf = cub_tree(d, "jax", "test", per_class=4)
    cfg = Config(dataset_name="cub", test_dataset_path=root, test_list=lf,
                 train=False, eval=True, eval_cub=True, shuffle_test=True,
                 dframe_eval=1, device="cpu", checkpoint_dir=str(d),
                 **TINY)
    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    tester = Tester(cfg)
    pred, fit = tester.predict_batch(batch)
    return cfg, tester, batch, pred, fit


def test_cub_fit_takes_the_default_pose(cub_eval):
    """CUB has no depth: every fit fails and takes the default pose
    (scale 0.1, 0.5 m ahead), as the JAX package's test pins."""
    _, _, _, _, fit = cub_eval
    assert not fit["ok"].any()
    np.testing.assert_allclose(fit["scale_fit"].numpy().ravel(), 0.1)
    np.testing.assert_allclose(fit["translation"].numpy()[:, 0, 2], 0.5)


def test_eval_cub_matches_jax(cub_eval):
    """The port's _eval_cub and the JAX tester's on the same batch, pred
    and fit: mask IoUs within 1e-3, the same PCK hits."""
    cfg, tester, batch, pred, fit = cub_eval
    ious, pck = tester._eval_cub(batch, pred, fit)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "img_size", "eval_cub", "vis_pred", "dataset_name")})
    jpred = {k: jnp.asarray(pred[k].numpy()) for k in ("faces", "match")}
    jfit = {"verts": jnp.asarray(fit["verts"].numpy())}
    want_iou, want_pck = [], []
    JTester._eval_cub(types.SimpleNamespace(cfg=jcfg), batch, jpred, jfit,
                      want_iou, want_pck)
    np.testing.assert_allclose(ious, want_iou, atol=1e-3, rtol=0)
    assert len(ious) == cfg.batch_size and max(ious) > 0
    assert np.asarray(pck).tolist() == np.asarray(want_pck).tolist()
    assert len(pck) > 0


def test_cub_eval_end_to_end(tmp_path):
    """The predict entry point with --dataset_name cub --eval --eval_cub on
    the CPU: finite mIoU and PCK."""
    from selfcorr_tpu_torch import predict
    root, lf = cub_tree(tmp_path, "port", "test", per_class=4)
    args = ["predict", "--dataset_name", "cub", "--test_dataset_path", root,
            "--test_list", lf, "--eval", "--eval_cub", "--dframe_eval", "1",
            "--device", "cpu", "--checkpoint_dir", str(tmp_path)]
    for k, v in TINY.items():
        args += [f"--{k}", str(v)]
    results = predict.main(args)
    assert 0.0 <= results["mIoU"] <= 1.0
    for k in ("kp@0.1", "kp@0.2"):
        assert np.isfinite(results[k]) and 0.0 <= results[k] <= 1.0, k

