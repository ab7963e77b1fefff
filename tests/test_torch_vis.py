"""The port's panels (utils/vis.py, numpy) against the JAX package's
(selfcorr_tpu/utils/vis.py, cv2) on the same numpy inputs, forward_vis
against the JAX forward_vis, and the panels and image logs the Tester and
the Trainer write, on the CPU. cv2 is imported here only.

The port keeps RGB in memory, the JAX package BGR: every comparison flips
the JAX image. Tolerances:
  * colormaps (JET, VIRIDIS), cv2's HSV conversion (kp_colormap, up to 31
    keypoints: cv2 converts longer rows another way), to_u8,
    colorize_canonical, grid_point_colors and the per-pixel panels (match,
    mask, depth diff): bit for bit;
  * bilinear resizing (the match panel pasted into the frame): within 1
    level (cv2 rounds its weights to 11 bits);
  * lines and circles (boxes, keypoints, point sets): at most 1% of the
    panel's pixels differ, and the masks of drawn pixels have an IoU of at
    least 0.9;
  * forward_vis against JAX forward_vis(use_pallas=True) in interpret mode
    at tests/test_vis_panels.py's tiny config (the trunk's attention in
    float32 in both, as tests/test_torch_train_step.py runs it), from the
    JAX initialization (BatchNorm statistics randomized) carried by
    from_jax_params, with the JAX draws injected: every product within
    1e-3, forward_test's tolerance.
"""
import glob
import inspect
import os
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from selfcorr_tpu.configs import Config as JConfig
from selfcorr_tpu.eval.tester import Tester as JTester
from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu.train.loop import Trainer as JTrainer
from selfcorr_tpu.train.step import init_state as jax_init_state
from selfcorr_tpu.utils import vis as JV
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data import fixtures as FX
from selfcorr_tpu_torch.data.loader import TestLoader
from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
from selfcorr_tpu_torch.models.meshnet import (MeshNet, build_mesh_constants,
                                               forward_vis)
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.ops.mesh_ops import load_obj
from selfcorr_tpu_torch.train import loop
from selfcorr_tpu_torch.utils import vis as V
from selfcorr_tpu_torch.utils import weight_convert as W
from test_torch_slice import jitter_factors, randomize_stats
from test_torch_threads import share_cores  # noqa: F401 (autouse)

TINY_VIS = dict(img_size=32, corr_h=8, corr_w=8, subdivide=1, batch_size=2,
                repeat=2, total_iters=10, symmetry_idx=0, symmetry_npts=128,
                use_depth=True, divide_fn="both", pretrain_k=8,
                n_corr_feat=16, codedim=8, depth_offset=5.0,
                dino_attn_bf16=False)
EVAL = dict(img_size=32, corr_h=8, corr_w=8, subdivide=1, batch_size=4,
            repeat=1, n_corr_feat=16, codedim=8, depth_offset=5.0,
            pose_fit_max_points=256, ransac_iters=8, num_workers=2,
            train=False, eval=True, dframe_eval=1, vis_pred=True)


def rgb(bgr):
    return np.ascontiguousarray(np.asarray(bgr)[..., ::-1])


def assert_drawn_alike(got, want_bgr, base, tag=""):
    """Lines and circles: at most 1% of the pixels differ, and the pixels
    each drew over `base` overlap with an IoU of at least 0.9."""
    want = rgb(want_bgr)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differ = (got != want).any(-1).mean()
    drawn_g, drawn_w = (got != base).any(-1), (want != base).any(-1)
    iou = (drawn_g & drawn_w).sum() / max((drawn_g | drawn_w).sum(), 1)
    assert differ <= 0.01 and iou >= 0.9, (tag, differ, iou)


# ---------------------------------------------------------------------------
# drawing functions
# ---------------------------------------------------------------------------


def test_colormaps_and_hsv_bit_for_bit():
    x = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(
        V.JET, rgb(cv2.applyColorMap(x, cv2.COLORMAP_JET)[0]))
    np.testing.assert_array_equal(
        V.VIRIDIS, rgb(cv2.applyColorMap(x, cv2.COLORMAP_VIRIDIS)[0]))
    rng = np.random.RandomState(0)
    conf, depth = rng.rand(24, 32), 5 + rng.rand(24, 32)
    mask = rng.rand(24, 32) > 0.3
    np.testing.assert_array_equal(V.draw_conf(conf), rgb(JV.draw_conf(conf)))
    np.testing.assert_array_equal(V.draw_depth(depth, mask),
                                  rgb(JV.draw_depth(depth, mask)))
    np.testing.assert_array_equal(V.draw_depth(depth),
                                  rgb(JV.draw_depth(depth)))
    # rows of fewer than 32 pixels, as kp_colormap converts them
    hsv = (rng.rand(400, 1, 31, 3) * [180, 256, 256]).astype(np.uint8)
    for row in hsv:
        np.testing.assert_array_equal(
            V.hsv_to_rgb_u8(row[0]),
            rgb(cv2.cvtColor(row, cv2.COLOR_HSV2BGR)[0]))
    for n in range(1, 32):
        np.testing.assert_array_equal(V.kp_colormap(n), rgb(JV.kp_colormap(n)))


def test_elementwise_panels_bit_for_bit():
    rng = np.random.RandomState(1)
    img = rng.rand(32, 32, 3).astype(np.float32)
    coords = rng.randn(32, 32, 3).astype(np.float32)
    pv = rng.randn(50, 3).astype(np.float32)
    mask = (rng.rand(32, 32) > 0.5).astype(np.float32)
    ranges = (pv.min(0), pv.max(0))
    np.testing.assert_array_equal(V.to_u8(img), JV.to_u8(img))
    for r in (None, ranges):
        np.testing.assert_array_equal(V.colorize_canonical(coords, r),
                                      JV.colorize_canonical(coords, r))
        np.testing.assert_array_equal(V.draw_match(img, coords, mask, r),
                                      rgb(JV.draw_match(img, coords, mask, r)))
    pts = rng.uniform(-1.2, 1.2, (40, 2))
    for order in ("cycle", "pt"):
        np.testing.assert_array_equal(V.grid_point_colors(pts, order),
                                      JV.grid_point_colors(pts, order))
    np.testing.assert_array_equal(V.draw_mask(mask), rgb(JV.draw_mask(mask)))
    diff = rng.randn(32, 32)
    np.testing.assert_array_equal(V.draw_depth_diff(diff),
                                  rgb(JV.draw_depth_diff(diff)))


def test_resize_and_paste_within_one_level():
    rng = np.random.RandomState(2)
    for (h, w), (oh, ow) in [((32, 32), (57, 43)), ((64, 48), (20, 90)),
                             ((32, 32), (32, 32))]:
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got = V.resize_linear_u8(img, ow, oh)
        assert np.abs(got.astype(int) - want).max() <= 1
    frame = (rng.rand(96, 120, 3) * 255).astype(np.uint8)
    panel = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    mask = (rng.rand(96, 120) > 0.4).astype(np.float32)
    for center, length in [((60, 48), (30, 25)), ((10, 90), (24, 30))]:
        got = V.paste_crop_panel(frame, panel, center, length, mask)
        want = rgb(JV.paste_crop_panel(rgb(frame), rgb(panel), center,
                                       length, mask))
        assert np.abs(got.astype(int) - want).max() <= 1


def random_box(rng, z=5.0):
    """A 9-point box (center + 8 corners) in camera space, in front."""
    size = rng.uniform(0.8, 2.0, 3)
    a = rng.uniform(-np.pi, np.pi, 3)
    rot = cv2.Rodrigues(a)[0]
    corners = np.array([[0, 0, 0]] + [[x, y, zz] for x in (-1, 1)
                                      for y in (-1, 1) for zz in (-1, 1)],
                       float) * 0.5 * size
    return corners @ rot.T + np.array([rng.uniform(-0.5, 0.5),
                                       rng.uniform(-0.5, 0.5), z])


@pytest.mark.parametrize("seed", range(4))
def test_lines_and_circles_drawn_alike(seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(64, 64, 3).astype(np.float32) * 0.5
    base = V.to_u8(img)
    box = random_box(rng)
    pp, foc = np.array([0.05, -0.05]), np.array([2.2, 2.2])
    assert_drawn_alike(V.draw_bbox3d(img, box, pp, foc),
                       JV.draw_bbox3d(img, box, pp, foc), base, "bbox3d")
    ppx, focx = np.array([60.0, 44.0]), np.array([110.0, 110.0])
    frame = (rng.rand(96, 120, 3) * 120).astype(np.uint8)
    for dirs in (True, False):
        assert_drawn_alike(
            V.draw_bboxes_pix(frame.copy(), box, ppx, focx,
                              with_dirs=dirs),
            JV.draw_bboxes_pix(rgb(frame), box, ppx, focx, with_dirs=dirs),
            frame, "bboxes_pix")
    pts2d = V.project_points(box, pp, foc, 64)
    assert_drawn_alike(V._draw_box_edges_at(base.copy(), pts2d),
                       JV._draw_box_edges_at(rgb(base), pts2d, box),
                       base, "box_edges_at")

    kps1, kps2, trans = rng.uniform(-0.9, 0.9, (3, 15, 2))
    kp_mask = (rng.rand(15) > 0.2).astype(np.float32)
    img2 = rng.rand(64, 64, 3).astype(np.float32)
    for got, want, b in zip(V.draw_kp(img, img2, kps1, kps2, trans, kp_mask),
                            JV.draw_kp(img, img2, kps1, kps2, trans, kp_mask),
                            (base, V.to_u8(img2), V.to_u8(img2))):
        assert_drawn_alike(got, want, b, "kp")

    pv = rng.randn(60, 3)
    imatch = rng.uniform(-1, 1, (60, 2))
    assert_drawn_alike(V.draw_imatch(img, imatch, pv),
                       JV.draw_imatch(img, imatch, pv), base, "imatch")
    colors = (rng.rand(60, 3) * 255).astype(np.uint8)
    weights = rng.rand(60)
    for kw in (dict(), dict(base=img, blend=0.3)):
        canvas = V.draw_point_set(imatch, colors, np.zeros(60), 64, **kw)
        assert_drawn_alike(
            V.draw_point_set(imatch, colors, weights, 64, **kw),
            JV.draw_point_set(imatch, colors, weights, 64, **kw), canvas,
            "point_set")


# ---------------------------------------------------------------------------
# forward_vis
# ---------------------------------------------------------------------------

VIS_KEYS = ("pred_v", "tex", "imatch", "match", "match_conf", "rotation",
            "translation", "scale", "match_gt", "tex_render", "mask_render",
            "depth_render", "depth_mask", "mean_v_depth", "mean_v_mask",
            "depth_diff", "imatch_gt", "depth_weight", "cycle_match",
            "cycle_match_gt", "cycle_mask", "pt_pts_src", "pt_pts_tgt",
            "pt_match", "pt_mask")


def np_batch(s=32, b=2, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.zeros((b, s, s), np.float32)
    mask[:, s // 4: 3 * s // 4, s // 4: 3 * s // 4] = 1.0
    return {"img": rng.rand(b, s, s, 3).astype(np.float32), "mask": mask,
            "depth": (mask * (5.0 + rng.rand(b, s, s))).astype(np.float32),
            "occ": np.zeros((b, s, s), np.float32),
            "pp_crop": np.zeros((b, 2), np.float32),
            "foc_crop": np.full((b, 2), 2.0, np.float32)}


@pytest.fixture(scope="module")
def vis_pair():
    """JAX forward_vis (Pallas rasterizer in interpret mode) and the
    port's on the same weights, batch and draws."""
    jcfg = JConfig(use_pallas=True, **TINY_VIS)
    constants = JM.build_mesh_constants(jcfg)
    state = jax.jit(lambda k: jax_init_state(jcfg, constants, k))(
        jax.random.PRNGKey(0))
    stats = randomize_stats(state.batch_stats)
    batch = np_batch()
    rng = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, s, d, bt, r: JM.forward_vis(
        p, s, d, bt, constants, r, jcfg, use_pallas=True))(
        state.params, stats, state.dino_params,
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    want = {k: np.asarray(v) for k, v in want.items()}

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    cfg = Config(device="cpu", **TINY_VIS)
    pconst = build_mesh_constants(cfg)
    model = MeshNet(cfg, pconst)
    model.load_state_dict(W.from_jax_params(to_np(state.params),
                                            to_np(stats)))
    model.train()
    dino = DinoViTS8(img_size=32, attn_bf16=False).eval()
    dino.load_state_dict(W.from_jax_dino_params(to_np(state.dino_params)))
    k_cyc, k_jit = jax.random.split(rng)
    got = forward_vis(
        model, dino, {k: torch.tensor(v) for k, v in batch.items()}, pconst,
        cfg, jitter=jitter_factors(rng),
        angle=torch.tensor(float(jax.random.uniform(k_cyc, (), minval=0.0,
                                                    maxval=360.0))),
        cycle_jitter=jitter_factors(k_jit))
    return cfg, batch, model, got, want


def test_forward_vis_matches_jax(vis_pair):
    cfg, _, model, got, want = vis_pair
    assert model.training        # the mode is restored
    for k in VIS_KEYS:
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0, err_msg=k)
    assert got["pt_pts_src"].shape == (1, cfg.pretrain_k, 2)
    assert float(got["pt_mask"].sum()) > 0 and float(
        got["mask_render"].max()) > 0


def test_train_panels_match_jax_drawing(vis_pair):
    """The trainer's panels from the port's products, against the JAX
    drawing functions on the same products, the tags the JAX trainer logs
    (read from its source)."""
    cfg, batch, _, got, _ = vis_pair
    v = {k: x.numpy() for k, x in got.items()}
    panels = V.train_panels(batch, v, cfg)
    src = inspect.getsource(JTrainer._log_images)
    assert set(panels) == set(re.findall(r'addim\(\s*"(vis/\w+)"', src))
    s, pv = cfg.img_size, v["pred_v"][0]
    np.testing.assert_array_equal(
        panels["vis/match"], rgb(JV.draw_match(
            batch["img"][0], v["match"][0], batch["mask"][0],
            (pv.min(0), pv.max(0)))))
    np.testing.assert_array_equal(
        panels["vis/depth_render"],
        rgb(JV.draw_depth(v["depth_render"][0], v["depth_mask"][0])))
    white = np.full((s, s, 3), 255, np.uint8)
    assert_drawn_alike(panels["vis/cycle_match"], JV.draw_point_set(
        v["cycle_match"][0], JV.grid_point_colors(v["cycle_match_gt"][0]),
        v["cycle_mask"][0], s), white, "cycle_match")
    assert_drawn_alike(panels["vis/pt_pred"], JV.draw_point_set(
        v["pt_match"][0], JV.grid_point_colors(v["pt_pts_tgt"][0], "pt"),
        v["pt_mask"][0], s), white, "pt_pred")
    for im in panels.values():
        assert im.shape == (s, s, 3) and im.dtype == np.uint8


def test_trainer_logs_images_every_vis_freq(tmp_path, monkeypatch):
    """A tiny Trainer run with --vis_freq 1 writes every image tag at each
    step, and the mean mesh's OBJ (tests/test_vis_panels.py's JAX
    check)."""
    class Recorder:
        def __init__(self):
            self.images = []

        def add_scalar(self, *a, **k):
            pass

        def add_image(self, tag, img, step, dataformats):
            self.images.append((tag, img.shape, img.dtype, step,
                                dataformats))

        def close(self):
            pass

    rec = Recorder()
    monkeypatch.setattr(loop, "make_writer", lambda d: rec)
    cfg = Config(dataset_name="synthetic", device="cpu", total_iters=2,
                 vis_freq=1, batch_log_interval=1, num_workers=2,
                 checkpoint_dir=str(tmp_path), name="vis",
                 **{k: v for k, v in TINY_VIS.items() if k != "total_iters"})
    loop.Trainer(cfg).train()
    src = inspect.getsource(JTrainer._log_images)
    tags = set(re.findall(r'addim\(\s*"(vis/\w+)"', src))
    for step in (1, 2):
        got = {r[0] for r in rec.images if r[3] == step}
        assert got == tags, (step, sorted(tags ^ got))
    assert all(r[1] == (32, 32, 3) and r[2] == np.uint8 and r[4] == "HWC"
               for r in rec.images)
    for step in (1, 2):
        verts, faces = load_obj(str(tmp_path / "vis" /
                                    f"{step}-iter-mean-mesh.obj"))
        assert verts.shape == (42, 3) and faces.shape == (80, 3)


# ---------------------------------------------------------------------------
# the Tester's panels on disk
# ---------------------------------------------------------------------------


def read_png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def panel_names(d):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(d,
                                                                      "*")))


@pytest.fixture(scope="module")
def w6d_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("w6dvis")
    _, test_root = FX.wild6d_tree(str(d), n_train_videos=0, n_test_videos=2,
                                  test_frames=2, raw_size=64)
    lst = str(d / "test.txt")
    FX.write_list(test_root, lst)
    return dict(dataset_name="Wild6D", test_dataset_path=test_root + "/",
                test_list=lst, use_depth=True, symmetry_idx=0, eval_nocs=True)


def test_tester_writes_the_jax_testers_files(w6d_tree, tmp_path):
    """--vis_pred on a Wild6D fixture: the port's Tester writes the file
    names the JAX Tester writes, every panel of every valid frame."""
    jt = JTester(JConfig(use_pallas=False, checkpoint_dir=str(tmp_path),
                         name="jrun", vis_path=str(tmp_path / "j"),
                         **EVAL, **w6d_tree))
    jt.test()
    Tester(Config(device="cpu", checkpoint_dir=str(tmp_path), name="prun",
                  vis_path=str(tmp_path / "p"), **EVAL, **w6d_tree)).test()
    want = panel_names(tmp_path / "j")
    assert panel_names(tmp_path / "p") == want
    assert len(want) == 4 * 12, want


@pytest.mark.parametrize("full_frame", [True, False])
def test_saved_panels_match_jax(w6d_tree, tmp_path, full_frame):
    """Both packages' save_visualizations on the same batch, predictions,
    fits and render panels (the port's): in the original frame and on the
    crop. Files decode alike within the tolerances above."""
    cfg = Config(device="cpu", checkpoint_dir=str(tmp_path), **EVAL,
                 **w6d_tree)
    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    tester = Tester(cfg)
    pred, fit = tester.predict_batch(batch)
    pred_np = {k: v.numpy() for k, v in pred.items()}
    fit_np = {k: v.numpy() for k, v in fit.items()}
    orig = renders = None
    if full_frame:
        orig = make_test_dataset(cfg).read_original(int(batch["idx"][0]),
                                                    int(batch["frame_idx"][0]))
        renders = tester._debug_panels(batch, pred, fit, 0, orig)
    V.save_visualizations(str(tmp_path / "p"), "t", batch, pred_np, fit_np,
                          0, cfg, orig=orig, renders=renders)
    JV.save_visualizations(
        str(tmp_path / "j"), "t", batch, pred_np, fit_np, 0,
        JConfig(**{k: v for k, v in {**EVAL, **w6d_tree}.items()}),
        orig=orig, renders=(None if renders is None else
                            {k: rgb(x) for k, x in renders.items()}))
    names = panel_names(tmp_path / "j")
    assert panel_names(tmp_path / "p") == names
    for name in names:
        p, j = str(tmp_path / "p" / name), str(tmp_path / "j" / name)
        if name.endswith(".obj"):
            assert open(p).read() == open(j).read()
            continue
        got, want = read_png(p), read_png(j)
        if name.endswith(("_bbox.png", "_gt.png", "_bbox_gt.png",
                          "_imatch.png")):
            base = read_png(str(tmp_path / "p" / "t_img.png"))
            assert_drawn_alike(got, rgb(want), base, name)
        elif name.endswith("_match.png") and full_frame:
            assert np.abs(got.astype(int) - want).max() <= 1, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_cub_keypoint_panels_match_jax(tmp_path):
    """--vis_pred --eval_cub: the port's Tester writes the JAX Tester's
    file names (crop panels and the _1 / _2 / _2_gt keypoint triples), and
    its keypoint panels draw as the JAX draw_kp does on the same
    inputs."""
    root = str(tmp_path / "cub" / "cub")
    lst = FX.cub_tree(root, per_class=2, split="test")
    kw = dict(EVAL, dataset_name="cub", test_dataset_path=root,
              test_list=lst, eval_cub=True, use_depth=False,
              symmetry_idx=-1, shuffle_test=True)
    JTester(JConfig(use_pallas=False, checkpoint_dir=str(tmp_path),
                    name="jrun", vis_path=str(tmp_path / "j"), **kw)).test()
    Tester(Config(device="cpu", checkpoint_dir=str(tmp_path), name="prun",
                  vis_path=str(tmp_path / "p"), **kw)).test()
    names = panel_names(tmp_path / "j")
    assert panel_names(tmp_path / "p") == names
    assert sum(n.endswith("_2_gt.png") for n in names) == 2
    rng = np.random.RandomState(5)
    img1, img2 = rng.rand(2, 32, 32, 3).astype(np.float32)
    kps1, kps2, trans = rng.uniform(-1, 1, (3, 15, 2))
    mask = (rng.rand(15) > 0.3).astype(np.float32)
    for got, want, b in zip(V.draw_kp(img1, img2, kps1, kps2, trans, mask),
                            JV.draw_kp(img1, img2, kps1, kps2, trans, mask),
                            (V.to_u8(img1), V.to_u8(img2), V.to_u8(img2))):
        assert_drawn_alike(got, want, b, "kp")
