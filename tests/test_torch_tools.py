"""The port's command-line layer (selfcorr_tpu_torch/tools/, scripts/) against
the JAX package's scripts/ on the CPU: the duo prior, the category priors,
the video lists, the learning check's Config and its run end to end at img
32, and the two shell scripts through bash.

The JAX script's Config is captured by running its main with
selfcorr_tpu.train.loop.Trainer replaced by a stub that records its
argument and stops: nothing trains."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from selfcorr_tpu_torch.data import fixtures as FX
from selfcorr_tpu_torch.data.synthetic import duo_prior_mesh
from selfcorr_tpu_torch.tools import gen_lists, gen_priors
from selfcorr_tpu_torch.tools import validate_synthetic as V
from test_torch_threads import share_cores  # noqa: F401 (autouse)
from test_torch_threads import thread_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIORS = os.path.join(ROOT, "config", "wild6d", "priors")
SCRIPTS = os.path.join(ROOT, "selfcorr_tpu_torch", "scripts")
ENV = dict(os.environ, JAX_PLATFORMS="cpu", **thread_env())
# the tests' small shapes for the train entry point
TINY = ["--img_size", "32", "--corr_h", "8", "--corr_w", "8",
        "--batch_size", "2", "--repeat", "2", "--pretrain_k", "8",
        "--n_corr_feat", "16", "--codedim", "8", "--symmetry_npts", "256",
        "--num_workers", "2", "--batch_log_interval", "1"]


def jax_script(name: str):
    """scripts/<name>.py as a module (the JAX package's scripts are files,
    not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("subdivide", [1, 2])
def test_duo_prior_mesh_equals_jax(subdivide):
    from selfcorr_tpu.data.synthetic import duo_prior_mesh as jax_duo
    v, f = duo_prior_mesh(subdivide)
    jv, jf = jax_duo(subdivide)
    assert v.dtype == jv.dtype == np.float64
    assert f.dtype == jf.dtype == np.int64
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_gen_priors_writes_the_committed_priors(tmp_path):
    """Byte for byte: the committed config/wild6d/priors/*.obj and the
    JAX package's scripts/gen_priors.py run as a script."""
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    gen_priors.main(str(port))
    out = subprocess.run([sys.executable, "scripts/gen_priors.py",
                          str(jax_out)], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    cats = sorted(gen_priors.GENERATORS)
    assert cats == ["bottle", "bowl", "camera", "laptop", "mug"]
    assert sorted(os.listdir(port)) == [f"{c}.obj" for c in cats]
    for c in cats:
        got = (port / f"{c}.obj").read_bytes()
        with open(os.path.join(PRIORS, f"{c}.obj"), "rb") as f:
            assert got == f.read(), c
        assert got == (jax_out / f"{c}.obj").read_bytes(), c


def test_check_mesh_refuses_open_and_inward_meshes():
    v, f = gen_priors.make_bottle()
    gen_priors.check_mesh(v, f)
    with pytest.raises(ValueError, match="non-manifold"):
        gen_priors.check_mesh(v, f[1:])
    with pytest.raises(ValueError, match="inward"):
        gen_priors.check_mesh(v, f[:, [0, 2, 1]])


def test_gen_lists_equals_the_jax_script(tmp_path, capsys):
    train_root, test_root = FX.wild6d_tree(str(tmp_path / "w6d"),
                                           frames_per_video=2, raw_size=48)
    os.makedirs(os.path.join(test_root, "zz_no_video", "0000"))
    jax_lists = jax_script("gen_lists")
    for i, root in enumerate((train_root, test_root)):
        mine, theirs = tmp_path / f"p{i}.txt", tmp_path / f"j{i}.txt"
        assert gen_lists.main(root, str(mine)) == 0
        assert jax_lists.main(root, str(theirs)) == 0
        assert mine.read_text() == theirs.read_text()
        assert mine.read_text().split() == gen_lists.enumerate_videos(root)
    assert gen_lists.main(str(tmp_path / "absent"), str(mine)) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert gen_lists.main(str(empty), str(mine)) == 2
    assert "no <object>/<sequence>/images/ videos" in capsys.readouterr().err


class _Captured(Exception):
    pass


def run_jax_validate(argv, monkeypatch):
    """scripts/validate_synthetic.py's main with `argv`, its Trainer a stub
    that raises _Captured(its Config), its persistent compile cache left
    off."""
    import selfcorr_tpu.train.loop as jax_loop
    import selfcorr_tpu.utils.jit_cache as jit_cache

    def stub(cfg):
        raise _Captured(cfg)
    monkeypatch.setattr(jax_loop, "Trainer", stub)
    monkeypatch.setattr(jit_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["validate_synthetic.py", *argv])
    jax_script("validate_synthetic").main()


def jax_config(argv, monkeypatch):
    """The Config scripts/validate_synthetic.py hands its Trainer."""
    with pytest.raises(_Captured) as got:
        run_jax_validate(argv, monkeypatch)
    return got.value.args[0]


ARMS = {
    "default": [],
    "freeze_prior": ["--freeze_prior"],
    "warm_start": ["--warm_start_path", "/runs/pre/ckpt"],
    **{f"ablate_{k}": ["--ablate", k] for k in V.ABLATABLE},
    "ablate_match_imatch": ["--ablate", "match,imatch"],
    "set_each_type": ["--set", "dino_bf16=1", "--set",
                      "steps_per_dispatch=3", "--set", "tau_img=7.5",
                      "--set", "synthetic_shape=mix", "--set",
                      "dino_flash=false"],
    "small_image": ["--img_size", "32", "--seed", "3", "--iters", "7",
                    "--save_freq", "2", "--vis_freq", "5", "--name", "x"],
    "img_64_warm_frozen": ["--img_size", "64", "--freeze_prior",
                           "--warm_start_path", "w"],
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_validate_config_equals_the_jax_scripts(arm, tmp_path,
                                                monkeypatch):
    argv = ARMS[arm] + ["--out_dir", str(tmp_path)]
    want = jax_config(argv, monkeypatch)
    args = V.parse_args(argv + ["--device", "cpu"])
    got = V.make_config(args, str(tmp_path),
                        os.path.join(str(tmp_path), "duo_prior.obj"))
    mine = dataclasses.asdict(got)
    assert mine.pop("device") == "cpu"
    assert mine == dataclasses.asdict(want)


@pytest.mark.parametrize("overrides,exc", [
    (["--set", "no_such_field=1"], KeyError),
    (["--set", "init_scale=1,1,1"], ValueError),
    (["--ablate", "nothing"], KeyError)])
def test_validate_config_refuses_what_the_jax_script_refuses(
        overrides, exc, tmp_path, monkeypatch):
    argv = overrides + ["--out_dir", str(tmp_path)]
    with pytest.raises(exc):
        run_jax_validate(argv, monkeypatch)
    with pytest.raises(exc):
        V.make_config(V.parse_args(argv + ["--device", "cpu"]),
                      str(tmp_path), "p.obj")


def test_validate_synthetic_end_to_end(tmp_path, capsys):
    """img 32, 2 steps with a checkpoint each, the step-1 checkpoint
    evaluated besides the final state: two JSON lines, the trajectory and
    results files; --eval_only over the same run gives the final line
    again. The duo prior written is the JAX package's."""
    from selfcorr_tpu.data.synthetic import duo_prior_mesh as jax_duo
    from selfcorr_tpu.ops.mesh_ops import save_obj as jax_save_obj
    argv = ["--img_size", "32", "--iters", "2", "--save_freq", "1",
            "--eval_steps", "1", "--device", "cpu", "--out_dir",
            str(tmp_path)]
    final = V.main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2 and lines[1] == final
    first, last = lines
    assert first["trajectory"] and first["iters"] == 1
    assert last["iters"] == 2 and last["name"] == "duo"
    keys = {"iou@25", "iou@50", "5deg2cm", "5deg5cm", "10deg2cm",
            "10deg5cm", "median_iou", "median_deg", "median_cm", "count"}
    assert keys <= set(first) and keys <= set(last)
    assert last["count"] == 48          # 4 videos x 12 frames
    assert all(np.isfinite(last[k]) for k in keys)
    with open(tmp_path / "duo-trajectory.jsonl") as f:
        assert [json.loads(ln) for ln in f] == [first]
    with open(tmp_path / "duo-results.json") as f:
        assert json.load(f) == last
    assert sorted(os.listdir(tmp_path / "duo" / "ckpt")) == ["1", "2"]
    jax_save_obj(str(tmp_path / "jax_prior.obj"), *jax_duo(2))
    assert ((tmp_path / "duo_prior.obj").read_bytes()
            == (tmp_path / "jax_prior.obj").read_bytes())
    again = V.main(["--img_size", "32", "--iters", "2", "--eval_only",
                    "--device", "cpu", "--out_dir", str(tmp_path)])
    assert again == last


def bash(script, *args, env=None):
    return subprocess.run(["bash", os.path.join(SCRIPTS, script), *args],
                          cwd=ROOT, env=dict(ENV, **(env or {})),
                          capture_output=True, text=True, timeout=600)


def test_train_sh_falls_back_to_synthetic_and_trains(tmp_path):
    out = bash("train.sh", "laptop", str(tmp_path / "absent"), "sh",
               "--device", "cpu", "--total_iters", "1", *TINY,
               "--checkpoint_dir", str(tmp_path / "log"),
               env={"SYNTH_FALLBACK": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "training on the SYNTHETIC procedural dataset" in out.stderr
    assert "iter 1/1" in out.stdout
    assert os.path.isfile(tmp_path / "log" / "sh" / "ckpt" / "1" / "state.pt")


def test_train_sh_without_the_dataset_exits_1(tmp_path):
    out = bash("train.sh", "laptop", str(tmp_path / "absent"), "sh",
               "--device", "cpu")
    assert out.returncode == 1
    assert "ERROR: Wild6D not found at" in out.stderr
    assert "SYNTH_FALLBACK=1" in out.stderr


def test_predict_sh_without_the_test_split_exits_2(tmp_path):
    out = bash("predict.sh", "laptop", str(tmp_path / "absent"),
               str(tmp_path / "ckpt"), "--device", "cpu")
    assert out.returncode == 2
    assert "ERROR: Wild6D test split not found at" in out.stderr


def gt_match_batch(img_size=64):
    """The learning check's duo test frames (4 videos, every second of 24
    frames; the first 8) at img_size with each pixel's match set to its
    exact object-frame point (the depth back-projected as the fit does,
    then taken through the inverse of the true pose), and pred_v the
    corners of each video's true object-frame box: what a perfectly
    learned model gives the fit."""
    import torch
    from selfcorr_tpu_torch.configs import Config
    from selfcorr_tpu_torch.data.synthetic import SyntheticTest
    from selfcorr_tpu_torch.eval.pose_fit import pixel_grid_ndc
    cfg = Config(dataset_name="synthetic", img_size=img_size, eval=True,
                 use_depth=True, dframe_eval=2, device="cpu")
    ds = SyntheticTest(cfg, num_videos=4, frames_per_video=24, seed=0,
                       shape="duo")
    items = [ds.load_item(i) for i in range(0, len(ds), 6)][:8]
    b = {k: np.stack([it[k] for it in items]) for k in (
        "depth", "mask", "pp_crop", "foc_crop", "rot_gt", "trans_gt",
        "scale_gt", "idx")}
    grid = pixel_grid_ndc(img_size, img_size).numpy()
    z = b["depth"]
    x = (grid[..., 0] - b["pp_crop"][:, None, None, 0]) * z \
        / b["foc_crop"][:, None, None, 0]
    y = (grid[..., 1] - b["pp_crop"][:, None, None, 1]) * z \
        / b["foc_crop"][:, None, None, 1]
    cam = np.stack([x, y, z], -1) * 0.001                    # metres
    corners = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                        for sz in (-.5, .5)])
    match, pred_v = [], []
    for i, vid in enumerate(b["idx"]):
        cb0, size = ds.videos.canonical_box(int(vid))
        r = b["rot_gt"][i].astype(np.float64)
        obj = (cam[i] - b["trans_gt"][i]) @ r + cb0           # R^T (X - t)
        match.append(np.where(b["mask"][i][..., None] > 0, obj, 0.0))
        pred_v.append(cb0 + corners * size)
    b["match"] = np.stack(match).astype(np.float32)
    b["pred_v"] = np.stack(pred_v).astype(np.float32)
    b["match_conf"] = (b["mask"] > 0).astype(np.float32)
    return b


def test_ground_truth_pose_scores_no_error_in_both_packages():
    """ROADMAP C.17: the evaluation behind the learning check's median_deg
    scores a perfect prediction as perfect in both packages. The duo test
    frames' exact object coordinates go through each package's pose fit
    (RANSAC-Umeyama, 16 iterations) and NOCS metrics: every frame under
    0.1 degrees and 0.1 cm with IoU above 0.99 (measured at most 0.017
    degrees and 0.044 cm, IoU at least 0.998: the crop's resized depth on
    the silhouette), the two packages within 1e-3 of each other (measured
    9.3e-5), and tests/split_c17.py's split of each frame's error under 0.1
    degrees too. A roll of 180 degrees about the lobe axis splits as one
    (within 0.1 degrees: the float32 ground truth near arccos(-1)), and
    the script's spread reads ~0 for one pose repeated and more than 45
    degrees for the spinning truth."""
    import jax
    import jax.numpy as jnp
    import torch
    from selfcorr_tpu.eval.metrics import NocsAccumulator as JAcc
    from selfcorr_tpu.eval.pose_fit import fit_poses as jax_fit_poses
    from selfcorr_tpu_torch.eval.box3d import Box3D
    from selfcorr_tpu_torch.eval.metrics import NocsAccumulator
    from selfcorr_tpu_torch.eval.pose_fit import fit_poses
    from split_c17 import split_rotation, spread
    b = gt_match_batch()
    t = {k: torch.as_tensor(b[k], dtype=torch.float32) for k in (
        "match", "match_conf", "depth", "mask", "pp_crop", "foc_crop",
        "pred_v")}
    fit = fit_poses(t["match"], t["match_conf"], t["depth"], t["mask"],
                    t["pp_crop"], t["foc_crop"], t["pred_v"], np.eye(3),
                    max_points=4096, n_iters=16,
                    generator=torch.Generator().manual_seed(0))
    jfit = jax_fit_poses(jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in (
        "match", "match_conf", "depth", "mask", "pp_crop", "foc_crop",
        "pred_v")), jnp.eye(3), max_points=4096, n_iters=16)
    assert bool(fit["ok"].all()) and bool(np.asarray(jfit["ok"]).all())
    acc, jacc = NocsAccumulator(-1), JAcc(-1)
    for i in range(len(b["idx"])):
        gt = (b["rot_gt"][i], b["trans_gt"][i], b["scale_gt"][i])
        acc.add(fit["bbox9"][i].numpy(), *gt)
        jacc.add(np.asarray(jfit["bbox9"][i]), *gt)
        split = split_rotation(Box3D(fit["bbox9"][i].numpy()).rotation,
                               b["rot_gt"][i])
        assert split["deg"] < 0.1 and split["lobe_deg"] < 0.1, split
        assert abs(split["roll_deg"]) < 0.1, split
    raw, jraw = np.asarray(acc.raw), np.asarray(jacc.raw)
    assert (raw[:, 0] > 0.99).all() and (raw[:, 1:] < 0.1).all(), raw
    assert (jraw[:, 0] > 0.99).all() and (jraw[:, 1:] < 0.1).all(), jraw
    np.testing.assert_allclose(raw, jraw, atol=1e-3, rtol=0)
    assert spread(fit["rotation"].numpy().transpose(0, 2, 1)[:1].repeat(
        3, 0)) < 0.1 and spread(b["rot_gt"]) > 45
    flip = np.diag([1.0, -1.0, -1.0])                   # 180 deg about +x
    for r in b["rot_gt"]:
        split = split_rotation(r @ flip, r)
        assert abs(split["deg"] - 180) < 0.1 and split["lobe_deg"] < 0.1
        assert abs(abs(split["roll_deg"]) - 180) < 0.1
