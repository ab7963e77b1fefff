"""The predict slice as a whole: the JAX forward_test + fit_poses and the
port's Tester.predict_batch on the same weights, batch and draws, then the
port's Tester.test() end to end on the CPU.

Weights are the JAX package's initialization (BatchNorm statistics
randomized) carried by from_jax_params; the color-jitter factors and the
RANSAC samples are the JAX draws. Tolerance 1e-3 absolute on every output,
bbox9 and verts included.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from selfcorr_tpu.configs import Config as JConfig
from selfcorr_tpu.eval.pose_fit import fit_poses as jax_fit_poses
from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.loader import TestLoader
from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
from selfcorr_tpu_torch.models.meshnet import MeshNet
from selfcorr_tpu_torch.utils import weight_convert as W
from selfcorr_tpu_torch.utils.imageio import read_unchanged
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SMALL = dict(dataset_name="synthetic", img_size=32, corr_h=8, corr_w=8,
             subdivide=1, batch_size=4, repeat=1, symmetry_idx=0,
             use_depth=True, n_corr_feat=16, codedim=8, depth_offset=5.0,
             eval=True, eval_nocs=True, dframe_eval=3,
             pose_fit_max_points=512, ransac_iters=8, num_workers=2,
             train=False)
NOCS_KEYS = ("iou@25", "iou@50", "5deg2cm", "5deg5cm", "10deg2cm",
             "10deg5cm")


def randomize_stats(stats, seed=0):
    rng = np.random.RandomState(seed)

    def f(path, x):
        if path[-1].key == "mean":
            return jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        return jnp.asarray(rng.rand(*x.shape).astype(np.float32) + 0.5)
    return jax.tree_util.tree_map_with_path(f, stats)


def jitter_factors(key):
    kb, kc, ks, kh = jax.random.split(key, 4)
    return torch.tensor([
        float(jax.random.uniform(kb, (), minval=0.8, maxval=1.2)),
        float(jax.random.uniform(kc, (), minval=0.8, maxval=1.2)),
        float(jax.random.uniform(ks, (), minval=0.8, maxval=1.2)),
        float(jax.random.uniform(kh, (), minval=-0.05, maxval=0.05))])


def ransac_samples(key, pred, batch, cfg):
    """The JAX fit's minimal samples (umeyama.py:85-87) on its pixel
    budget (pose_fit.py:40-45)."""
    b = batch["depth"].shape[0]
    weight = ((batch["depth"] > 0) & (batch["mask"] > 0)
              & (np.asarray(pred["match_conf"]) > 0))
    flat_w = jnp.asarray(weight.reshape(b, -1).astype(np.float32))
    score = flat_w * (1.0 + pred["match_conf"].reshape(b, -1))
    _, idx = jax.lax.top_k(score, min(cfg.pose_fit_max_points,
                                      flat_w.shape[1]))
    valid = jnp.take_along_axis(flat_w, idx, 1) > 0
    keys = jax.random.split(key, b)
    return torch.tensor(np.stack([np.asarray(jax.random.categorical(
        keys[i], jnp.where(valid[i], 0.0, -jnp.inf)[None, None, :],
        axis=-1, shape=(cfg.ransac_iters, 5))) for i in range(b)]))


def test_predict_batch_matches_jax(tmp_path):
    cfg = Config(device="cpu", checkpoint_dir=str(tmp_path), name="p",
                 **SMALL)
    jcfg = JConfig(checkpoint_dir=str(tmp_path), name="j", **SMALL)
    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    assert batch["valid"].all()

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
    k_fwd, k_fit = jax.random.split(jax.random.PRNGKey(42))
    jpred = jax.jit(lambda p, s, bt, r: JM.forward_test(
        p, s, bt, constants, r, jcfg))(params, stats, jb, k_fwd)
    jfit = jax_fit_poses(k_fit, jpred["match"], jpred["match_conf"],
                         jb["depth"], jb["mask"], jb["pp_crop"],
                         jb["foc_crop"], jpred["pred_v"],
                         jnp.asarray(constants.base_rot),
                         max_points=jcfg.pose_fit_max_points,
                         n_iters=jcfg.ransac_iters)

    tester = Tester(cfg)
    model = MeshNet(cfg, tester.constants)
    model.load_state_dict(W.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)))
    tester = Tester(cfg, model=model)
    pred, fit = tester.predict_batch(
        batch, jitter=jitter_factors(k_fwd),
        sample_idx=ransac_samples(k_fit, jpred, batch, cfg))

    for k in ("pred_v", "tex", "imatch", "match", "match_conf", "rotation",
              "translation", "scale"):
        np.testing.assert_allclose(pred[k].numpy(), np.asarray(jpred[k]),
                                   atol=1e-3, rtol=0, err_msg=k)
    np.testing.assert_array_equal(pred["faces"].numpy(),
                                  np.asarray(jpred["faces"]))
    for k in ("bbox9", "verts", "rotation", "translation", "scale_fit"):
        np.testing.assert_allclose(fit[k].numpy(), np.asarray(jfit[k]),
                                   atol=1e-3, rtol=0, err_msg=k)
    np.testing.assert_array_equal(fit["ok"].numpy(), np.asarray(jfit["ok"]))


def test_tester_end_to_end_on_cpu(tmp_path):
    """predict path with the render panels, on the CPU: six finite NOCS
    metrics, and per valid sample the frame and its three full-frame render
    panels."""
    vis = tmp_path / "vis"
    cfg = Config(device="cpu", checkpoint_dir=str(tmp_path), name="e2e",
                 vis_pred=True, visualize_mask=True, visualize_tex=True,
                 visualize_depth=True, vis_path=str(vis), **SMALL)
    results = Tester(cfg).test()
    for k in NOCS_KEYS:
        assert np.isfinite(results[k]) and 0.0 <= results[k] <= 1.0, k
    assert results["count"] == 4
    files = sorted(os.listdir(vis))
    assert len(files) == 16, files
    panel = read_unchanged(str(vis / files[0]))
    assert panel.shape == (320, 320, 3) and panel.dtype == np.uint8
    mask = read_unchanged(str(vis / "000_000_mask.png"))
    assert mask.max() > 0  # the fitted mesh lands in the frame
