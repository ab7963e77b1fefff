"""The port's image files and Wild6D / NOCS readers against cv2 and the JAX
package's readers on the same files, then the predict path and the entry
points on a Wild6D fixture, on the CPU.

Tolerances: decoded pixels, masks, depths, intrinsics, GT and indices
exact; the bilinear image plane of a crop within 1e-5 (the port's resize
repeats cv2's arithmetic in another order); the predict path's outputs
within 1e-3, as tests/test_torch_slice.py holds them; the six NOCS metrics
equal. Trees are written at raw 96 (NOCS 48 x 64), crops at img 32.
"""
import importlib.util
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfcorr_tpu.configs import Config as JConfig
from selfcorr_tpu.data import nocs as JN
from selfcorr_tpu.data import wild6d as JW
from selfcorr_tpu.eval.metrics import NocsAccumulator as JaxAccumulator
from selfcorr_tpu.eval.pose_fit import fit_poses as jax_fit_poses
from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data import fixtures as FX
from selfcorr_tpu_torch.data import nocs as N
from selfcorr_tpu_torch.data import wild6d as W
from selfcorr_tpu_torch.data.loader import TestLoader
from selfcorr_tpu_torch.eval.metrics import NocsAccumulator
from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
from selfcorr_tpu_torch.models.meshnet import MeshNet
from selfcorr_tpu_torch.train.loop import Trainer
from selfcorr_tpu_torch.utils import imageio as io
from selfcorr_tpu_torch.utils import weight_convert as WC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts.gen_lists import main as gen_lists  # noqa: E402
from scripts.gen_wild6d_fixture import generate  # noqa: E402
from test_datasets import make_nocs_tree  # noqa: E402
from test_torch_slice import (NOCS_KEYS, jitter_factors,  # noqa: E402
                              randomize_stats, ransac_samples)

BILINEAR = ("img",)
TINY = dict(img_size=32, corr_h=8, corr_w=8, subdivide=1, batch_size=4,
            repeat=1, symmetry_idx=0, use_depth=True, n_corr_feat=16,
            codedim=8, depth_offset=5.0, pose_fit_max_points=512,
            ransac_iters=8, num_workers=2, pretrain_k=8, symmetry_npts=256)


def assert_items_equal(got: dict, want: dict, tag=""):
    assert set(got) == set(want), (tag, sorted(got), sorted(want))
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (tag, k, g.dtype,
                                                           w.dtype, g.shape)
        if k in BILINEAR:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                       err_msg=f"{tag} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")


def same_draws(rng: np.random.RandomState) -> np.random.RandomState:
    """A RandomState at rng's state: what rng will draw next."""
    r = np.random.RandomState()
    r.set_state(rng.get_state())
    return r


@pytest.fixture(scope="module")
def w6d(tmp_path_factory):
    """A Wild6D tree written by the JAX package's fixture script (cv2),
    with its list files."""
    d = str(tmp_path_factory.mktemp("w6d"))
    train_root, test_root = generate(
        d, n_train_videos=2, n_test_videos=2, frames_per_video=4,
        test_frames=3, raw_size=96, seed=0)
    assert gen_lists(train_root, os.path.join(d, "train.txt")) == 0
    assert gen_lists(test_root, os.path.join(d, "test.txt")) == 0
    return dict(dataset_name="Wild6D", dataset_path=train_root,
                train_list=os.path.join(d, "train.txt"),
                test_dataset_path=test_root + "/",
                test_list=os.path.join(d, "test.txt"))


# --------------------------------------------------------------------------
# image files


def cv2_files(d):
    rng = np.random.RandomState(3)
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    img[8:30, 10:40] = (40, 200, 90)     # flat areas beside the noise
    mask = np.zeros((48, 64), np.uint8)
    mask[10:30, 12:50] = 255
    depth = (rng.rand(48, 64) * 5000).astype(np.uint16)
    paths = {k: os.path.join(d, n) for k, n in (
        ("jpeg", "a.jpg"), ("mask", "m.png"), ("depth", "d.png"),
        ("rgb_png", "c.png"))}
    cv2.imwrite(paths["jpeg"], img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    cv2.imwrite(paths["mask"], mask)
    cv2.imwrite(paths["depth"], depth)
    cv2.imwrite(paths["rgb_png"], img)
    return paths


@pytest.mark.parametrize("kind", ["jpeg", "mask", "depth", "rgb_png"])
def test_imageio_decodes_cv2_files_like_cv2(kind, tmp_path):
    p = cv2_files(str(tmp_path))[kind]
    if kind in ("jpeg", "rgb_png"):
        want = cv2.imread(p)[:, :, ::-1].astype(np.float32) / 255.0
        got = io.read_rgb(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if kind == "mask":
        np.testing.assert_array_equal(
            io.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    else:   # the masks are 8-bit gray PNGs; nothing else is converted
        with pytest.raises(ValueError, match="8-bit gray PNGs"):
            io.read_gray(p)
    want = cv2.imread(p, -1)
    got = io.read_unchanged(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["jpeg", "gray", "rgb", "depth16"])
def test_imageio_writes_files_cv2_reads_back(kind, tmp_path):
    """The port's writers: PNGs read back through cv2 unchanged; a JPEG
    decodes alike through cv2 and the port."""
    rng = np.random.RandomState(4)
    rgb = (rng.rand(40, 56, 3) * 255).astype(np.uint8)
    if kind == "jpeg":
        # a smooth image, so that quality 95 keeps it within a few levels
        y, x = np.mgrid[0:40, 0:56]
        smooth = np.stack([x * 4, y * 5, 128 + x - y], -1).astype(np.uint8)
        p = str(tmp_path / "x.jpg")
        io.write_jpeg(p, smooth, 95)
        np.testing.assert_array_equal(
            cv2.imread(p)[:, :, ::-1].astype(np.float32) / 255.0,
            io.read_rgb(p))
        assert np.abs(cv2.imread(p)[:, :, ::-1].astype(int)
                      - smooth).max() <= 4
        return
    img = {"gray": rgb[..., 0], "rgb": rgb,
           "depth16": (rng.rand(40, 56) * 65535).astype(np.uint16)}[kind]
    p = str(tmp_path / "x.png")
    io.write_png(p, img)
    back = cv2.imread(p, -1)
    np.testing.assert_array_equal(back[..., ::-1] if kind == "rgb" else back,
                                  img)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(io.read_unchanged(p), back)


def test_imageio_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        io.write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))


# --------------------------------------------------------------------------
# Wild6D


def test_wild6d_test_items_match_jax(w6d):
    kw = dict(w6d, img_size=32, use_depth=True, eval=True, dframe_eval=1)
    ref, ours = JW.Wild6DTest(JConfig(**kw)), W.Wild6DTest(Config(**kw))
    assert ours.samples == ref.samples and len(ours) == 6
    for i in range(len(ref)):
        assert_items_equal(ours.load_item(i), ref.load_item(i), f"item {i}")
    got, want = ours.read_original(1, 2), ref.read_original(1, 2)
    assert_items_equal(got, want, "original")
    assert got["mask"].sum() > 0 and got["depth"].max() > 1000


@pytest.mark.parametrize("no_stretch", [False, True])
def test_wild6d_train_items_match_jax(w6d, no_stretch):
    """load_item with the crop scale the JAX reader draws for itself;
    sample_plan draws (vid, fid, scale) per entry, video-major."""
    kw = dict(w6d, img_size=32, use_depth=True, batch_size=3, repeat=2,
              no_stretch=no_stretch)
    ref, ours = JW.Wild6DTrain(JConfig(**kw)), W.Wild6DTrain(Config(**kw))
    for vid, fid in [(0, 1), (1, 3), (1, 0)]:
        scale = same_draws(ref.rng).uniform(1.2, 1.5, size=(2,))
        assert_items_equal(ours.load_item(vid, fid, scale),
                           ref.load_item(vid, fid), f"{vid}/{fid}")
    plan = ours.sample_plan(0)
    assert len(plan) == 6
    for j, (vid, fid, scale) in enumerate(plan):
        assert vid == plan[j - j % 2][0] and fid in (2 * (j % 2),
                                                     2 * (j % 2) + 1)
        assert np.all((scale >= 1.2) & (scale < 1.5))


def test_fixture_tree_reads_alike(tmp_path):
    """The port's fixture writer (Pillow): the JAX readers (cv2) read its
    tree as the port's readers do; its lists are gen_lists' lists."""
    train_root, test_root = FX.wild6d_tree(
        str(tmp_path), n_train_videos=2, n_test_videos=2,
        frames_per_video=3, test_frames=2, raw_size=96)
    for root, name in ((train_root, "train"), (test_root, "test")):
        assert FX.write_list(root, str(tmp_path / f"{name}.txt")) == 2
        assert gen_lists(root, str(tmp_path / f"{name}_ref.txt")) == 0
        assert (tmp_path / f"{name}.txt").read_text() == (
            tmp_path / f"{name}_ref.txt").read_text()
    kw = dict(dataset_name="Wild6D", dataset_path=train_root,
              train_list=str(tmp_path / "train.txt"),
              test_dataset_path=test_root + "/",
              test_list=str(tmp_path / "test.txt"), img_size=32,
              use_depth=True, eval=True, dframe_eval=1)
    ref, ours = JW.Wild6DTest(JConfig(**kw)), W.Wild6DTest(Config(**kw))
    for i in range(len(ref)):
        assert_items_equal(ours.load_item(i), ref.load_item(i), f"item {i}")
    ref_v, our_v = ref.videos, ours.videos
    for vid, fid in [(0, 1), (1, 0)]:
        for a, b in zip(our_v.read_frame(vid, fid, True),
                        ref_v.read_frame(vid, fid, True)):
            np.testing.assert_array_equal(a, b)
    tr = W.Wild6DTrain(Config(**kw))
    assert tr.videos.num_frames(1) == 3


def test_fixture_gt_is_the_ray_tracers(tmp_path):
    """The port's fixture stores the JAX script's GT poses."""
    sys.path.insert(0, ROOT)
    from scripts.gen_wild6d_fixture import _gt_pose
    from selfcorr_tpu.data.synthetic import SyntheticVideos as JVideos
    from selfcorr_tpu_torch.data.synthetic import SyntheticVideos
    ours = SyntheticVideos(2, 5, raw_size=96, seed=0, shape="duo")
    ref = JVideos(2, 5, raw_size=96, seed=0, shape="duo")
    for vid, fid in [(0, 0), (1, 3)]:
        for a, b in zip(FX.gt_pose(ours, vid, fid), _gt_pose(ref, vid, fid)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# NOCS


def nocs_tree(tmp_path, maker):
    root = str(tmp_path / "real")
    if maker == "jax":
        os.makedirs(root)
        return root, make_nocs_tree(root)
    return root, FX.nocs_tree(root, hw=(48, 64))


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_nocs_items_match_jax(tmp_path, maker):
    """Both trees: the JAX helper's (cv2, one instance, no extents file:
    the isotropic size) and the port's (an occluding second instance and
    obj_models/real_test.pkl: occ and the extents)."""
    root, list_file = nocs_tree(tmp_path, maker)
    kw = dict(dataset_name="nocs", category="laptop", dataset_path=root,
              train_list=list_file, test_dataset_path=root,
              test_list=list_file, img_size=32, batch_size=2, repeat=2,
              use_depth=True, use_occ=True, eval=True, dframe_eval=1)
    ref, ours = JN.NOCSTest(JConfig(**kw)), N.NOCSTest(Config(**kw))
    assert ours.samples == ref.samples and len(ours) == 3
    for i in range(len(ref)):
        item = ours.load_item(i)
        assert_items_equal(item, ref.load_item(i), f"test {i}")
    assert_items_equal(ours.read_original(0, 1), ref.read_original(0, 1))
    np.testing.assert_array_equal(item["rot_gt"] @ np.diag([1, -1, -1]),
                                  np.eye(3))
    if maker == "port":
        assert item["occ"].sum() > 0 and ours.extents is not None
        assert len(set(np.round(item["scale_gt"], 6))) == 3
    else:
        np.testing.assert_array_equal(item["scale_gt"], np.ones(3))

    ref_t, ours_t = JN.NOCSTrain(JConfig(**kw)), N.NOCSTrain(Config(**kw))
    assert len(ours_t.tracks) == len(ref_t.tracks) == 1
    for fid in (0, 2):
        scale = same_draws(ref_t.rng).uniform(1.1, 1.3, size=(2,))
        assert_items_equal(ours_t.load_item(0, fid, scale),
                           ref_t.load_item(0, fid), f"train {fid}")
    assert [p[:2] for p in ours_t.sample_plan(0)] == [(0, 0), (0, 1)] * 2


# --------------------------------------------------------------------------
# the predict path and the entry points on the Wild6D fixture


@pytest.fixture(scope="module")
def jax_predict(w6d, tmp_path_factory):
    """The JAX forward_test + fit_poses on the fixture's first test batch,
    from seeded weights (one compile for the module)."""
    d = str(tmp_path_factory.mktemp("pred"))
    kw = dict(w6d, **TINY, eval=True, eval_nocs=True, dframe_eval=1,
              train=False)
    cfg = Config(device="cpu", checkpoint_dir=d, name="p", **kw)
    jcfg = JConfig(checkpoint_dir=d, name="j", **kw)
    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    constants = JM.build_mesh_constants(jcfg)
    net = JM.Networks(jcfg)
    b = cfg.batch_size
    v = jax.jit(lambda k: net.init(
        k, jnp.zeros((b, 32, 32, 3)),
        jnp.zeros((b,) + constants.mean_v_init.shape), jnp.zeros((b, 2)),
        jnp.ones((b, 2)), False))(jax.random.PRNGKey(0))
    stats = randomize_stats(v["batch_stats"])
    params = {"net": v["params"], "mean_v": jnp.asarray(constants.mean_v_init)}
    jb = {k: jnp.asarray(batch[k]) for k in ("img", "mask", "depth", "occ",
                                             "pp_crop", "foc_crop")}
    k_fwd, k_fit = jax.random.split(jax.random.PRNGKey(7))
    jpred = jax.jit(lambda p, s, bt, r: JM.forward_test(
        p, s, bt, constants, r, jcfg))(params, stats, jb, k_fwd)
    jfit = jax_fit_poses(k_fit, jpred["match"], jpred["match_conf"],
                         jb["depth"], jb["mask"], jb["pp_crop"],
                         jb["foc_crop"], jpred["pred_v"],
                         jnp.asarray(constants.base_rot),
                         max_points=jcfg.pose_fit_max_points,
                         n_iters=jcfg.ransac_iters)
    sd = WC.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            jax.tree_util.tree_map(np.asarray, stats))
    return dict(cfg=cfg, batch=batch, jpred=jpred, jfit=jfit, state=sd,
                jitter=jitter_factors(k_fwd),
                sample_idx=ransac_samples(k_fit, jpred, batch, cfg))


def test_predict_on_wild6d_fixture_matches_jax(jax_predict):
    r = jax_predict
    cfg, batch = r["cfg"], r["batch"]
    assert batch["valid"].all()
    tester = Tester(cfg)
    model = MeshNet(cfg, tester.constants)
    model.load_state_dict(r["state"])
    tester = Tester(cfg, model=model)
    pred, fit = tester.predict_batch(batch, jitter=r["jitter"],
                                     sample_idx=r["sample_idx"])
    for k in ("match", "match_conf", "rotation"):
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(r["jpred"][k]),
                                   atol=1e-3, rtol=0, err_msg=k)
    bbox9 = fit["bbox9"].numpy()
    jbbox9 = np.asarray(r["jfit"]["bbox9"])
    np.testing.assert_allclose(bbox9, jbbox9, atol=1e-3, rtol=0)
    ours, ref = NocsAccumulator(cfg.symmetry_idx), JaxAccumulator(
        cfg.symmetry_idx)
    for i in range(cfg.batch_size):
        ours.add(bbox9[i], batch["rot_gt"][i], batch["trans_gt"][i],
                 batch["scale_gt"][i])
        ref.add(jbbox9[i], batch["rot_gt"][i], batch["trans_gt"][i],
                batch["scale_gt"][i])
    got, want = ours.summary(), ref.summary()
    for k in NOCS_KEYS + ("count",):
        assert got[k] == want[k], (k, got[k], want[k])


def test_tester_end_to_end_on_wild6d_fixture(w6d, tmp_path):
    """The predict entry point on the fixture, on the CPU: six finite NOCS
    metrics over every test frame, and every panel of each."""
    from selfcorr_tpu_torch import predict
    args = ["predict", "--flagfile", os.path.join(ROOT,
                                                  "config/wild6d/laptop.txt")]
    for k, v in dict(w6d, **TINY).items():
        args += [f"--{k}", str(v)]
    args += ["--eval", "--eval_nocs", "--dframe_eval", "1", "--vis_pred",
             "--device", "cpu", "--checkpoint_dir", str(tmp_path)]
    results = predict.main(args)
    assert results["count"] == 6
    for k in NOCS_KEYS:
        assert np.isfinite(results[k]) and 0.0 <= results[k] <= 1.0, k
    # every panel of each frame: the frame, box, match, imatch, GT box and
    # depth, the three renders, confidence, mesh, and the 3D figure (when
    # matplotlib is installed)
    names = os.listdir(tmp_path / "exp" / "vis")
    assert len({n[:7] for n in names}) == 6
    per_frame = 11 + (importlib.util.find_spec("matplotlib") is not None)
    assert len(names) == 6 * per_frame, sorted(names)


def test_tester_end_to_end_on_nocs_fixture(tmp_path):
    root, list_file = nocs_tree(tmp_path, "port")
    cfg = Config(dataset_name="nocs", category="laptop",
                 test_dataset_path=root, test_list=list_file, use_occ=True,
                 eval=True, eval_nocs=True, dframe_eval=1, train=False,
                 device="cpu", checkpoint_dir=str(tmp_path), **TINY)
    results = Tester(cfg).test()
    assert results["count"] == 3
    for k in NOCS_KEYS:
        assert np.isfinite(results[k]), k


def test_trainer_one_step_on_wild6d_fixture(w6d, tmp_path):
    """One step of the training entry point on the fixture, on the CPU:
    the loader's batch comes from the reader, every logged loss finite."""
    cfg = Config(**w6d, **TINY, total_iters=1, batch_log_interval=1,
                 device="cpu", checkpoint_dir=str(tmp_path), name="t")
    cfg = cfg.replace(batch_size=2, repeat=2)
    trainer = Trainer(cfg)
    trainer.train()
    assert trainer.state.step == 1 and len(trainer.logged) == 1
    assert all(np.isfinite(v) for v in trainer.logged[0][1].values())
    assert torch.isfinite(next(trainer.state.model.parameters())).all()
