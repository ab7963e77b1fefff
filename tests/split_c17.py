"""The split of ROADMAP C.17: where the learning check's rotation error lies,
frame by frame.

Trains a run of selfcorr_tpu_torch/tools/validate_synthetic.py (its flags;
--eval_only reads the run already in --out_dir), then evaluates the run's
last checkpoint on the learning check's duo test videos frame by frame, as
the check's Tester does (the same fit and the same error), and splits each
frame's rotation error R_gt^T R_pred, taken in the object frame, in two:

  lobe_deg  the angle between the predicted and the true lobe axes (+x,
            the axis of the duo's small lobe, which its geometry fixes);
  roll_deg  the rotation about the true lobe axis left once the lobe axes
            are aligned, in (-180, 180]. The duo is two ellipsoids on the
            x axis, so a roll of 180 degrees leaves its geometry unchanged
            (only its texture tells), and the duo prior, two spheres on
            that axis, is the same under every roll.

It prints, per video and for all frames, the median error, the median
lobe_deg, the rolls' circular mean and spread, a histogram of the error in
30-degree bins, and how far the fitted rotations, the rotation head's own
(forward_test's `rotation`) and the true ones spread about their mean
(the median angle to their chordal mean: a model that predicts one pose for
every frame reads near 0 while the truth spins), as one JSON line each, and
writes one JSON line per frame to <out_dir>/<name>-frames.jsonl.

    python tests/split_c17.py --img_size 256 --iters 1000 --seed 0 \\
        --save_freq 500 --out_dir <dir>                 # on the card
    python tests/split_c17.py --img_size 32 --iters 2 --save_freq 1 \\
        --device cpu --out_dir <dir>                    # a tiny CPU run

It imports only the port (it runs where JAX is not installed), but for
its `spread` subcommand, which imports the JAX package too and runs on the
CPU. That one compares the two packages' rotation heads on the same duo
test frames (the learning check's evaluation set at --img_size, under the
same jitter factors), printing one JSON line each:

  at init, for each of --seeds: the head's spread under JAX's init_state
  (PRNGKey(seed)) through the JAX forward_test, the same weights in the
  port (weight_convert.from_jax_params), and the port's own init_model;

  with --iters N, along one training run of the check's recipe in each of
  --packages, saving every --save_freq steps: `jax` (the JAX Trainer, from
  its init at --seed), `port` (the port's Trainer from the same JAX
  weights, through a step-0 checkpoint) and `port_own` (the port's Trainer
  from its own init): the head's spread at step 0 and at each save.

    python tests/split_c17.py spread --img_size 64 --seeds 0,1,2,3,4 \\
        --out_dir <dir>                                 # at init, ~2 min
    python tests/split_c17.py spread --img_size 64 --seeds 0 --iters 300 \\
        --save_freq 100 --packages jax --out_dir <dir>  # one package a run

Its `jax_start` subcommand (the JAX package, on the CPU) takes
validate_synthetic's flags and writes the JAX init_state of --seed as a
step-0 checkpoint of that run in --out_dir, so that validate_synthetic
(or this script) with the same flags on the card trains the port from
JAX's very weights:

    python tests/split_c17.py jax_start --img_size 256 --iters 1000 \\
        --out_dir <dir>

It is a script, not a test (pytest does not collect it);
tests/test_torch_tools.py tests split_rotation.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# how far rotations spread about their mean (the port's; imported here)
from selfcorr_tpu_torch.eval.metrics import rotation_spread as spread  # noqa


def _angle(cos) -> float:
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def split_rotation(rot_pred, rot_gt) -> dict:
    """deg, lobe_deg and roll_deg (module docstring) of a predicted
    rotation against the true one, both column-acting (3, 3)."""
    rel = np.asarray(rot_gt, np.float64).T @ np.asarray(rot_pred, np.float64)
    lobe = rel[:, 0] / np.linalg.norm(rel[:, 0])
    # the least rotation taking the predicted lobe axis onto +x (about z
    # when the two are opposite), then what is left is a roll about +x
    axis = np.cross(lobe, [1.0, 0.0, 0.0])
    s, c = np.linalg.norm(axis), lobe[0]
    axis = axis / s if s > 1e-9 else np.array([0.0, 0.0, 1.0])
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    ang = np.arctan2(s, c)
    align = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
    m = align @ rel
    return {"deg": _angle((np.trace(rel) - 1) / 2),
            "lobe_deg": _angle(c),
            "roll_deg": float(np.degrees(np.arctan2(m[2, 1], m[1, 1])))}


def summarize(rows) -> dict:
    """The median error and lobe_deg, the rolls' circular mean and spread
    (the mean resultant length, 1 when every roll is the same), the
    error's histogram in 30-degree bins from 0 to 180, and the spreads of
    the fitted, the head's and the true rotations."""
    deg = np.array([r["deg"] for r in rows])
    roll = np.radians([r["roll_deg"] for r in rows])
    z = np.exp(1j * roll).mean()
    return {"frames": len(rows), "median_deg": round(float(np.median(deg)), 2),
            "median_lobe_deg": round(float(np.median(
                [r["lobe_deg"] for r in rows])), 2),
            "roll_mean_deg": round(float(np.degrees(np.angle(z))), 2),
            "roll_resultant": round(float(abs(z)), 3),
            "deg_hist_30": np.histogram(deg, bins=6, range=(0, 180))[
                0].tolist(),
            **{f"{k}_spread_deg": round(spread([r[f"rot_{k}"] for r in rows]),
                                        2) for k in ("pred", "head", "gt")}}


def frames(cfg, model_path: str, seed: int) -> list:
    """One row per valid frame of the duo test videos: video, frame, the
    error's split, cm, and the fitted, the head's and the true rotations."""
    from selfcorr_tpu_torch.data.loader import TestLoader
    from selfcorr_tpu_torch.data.synthetic import SyntheticTest
    from selfcorr_tpu_torch.eval.box3d import Box3D
    from selfcorr_tpu_torch.eval.metrics import deg_cm_error
    from selfcorr_tpu_torch.eval.tester import Tester
    tester = Tester(cfg.replace(model_path=model_path))
    dataset = SyntheticTest(tester.cfg, num_videos=4, frames_per_video=24,
                            seed=seed, shape="duo")
    loader = TestLoader(dataset, tester.cfg)
    rows = []
    try:
        for batch in loader:
            pred, fit = tester.predict_batch(batch)
            bbox9 = fit["bbox9"].cpu().numpy()
            head = pred["rotation"].cpu().numpy()
            for i in np.flatnonzero(batch["valid"]):
                box = Box3D(bbox9[i])
                rot_gt = np.asarray(batch["rot_gt"][i], np.float64)
                deg, cm = deg_cm_error(-1, box, rot_gt, batch["trans_gt"][i],
                                       batch["scale_gt"][i])
                split = split_rotation(box.rotation, rot_gt)
                rows.append({"video": int(batch["idx"][i]),
                             "frame": int(batch["frame_idx"][i]),
                             **{k: round(v, 3) for k, v in split.items()},
                             "metric_deg": round(deg, 3),
                             "cm": round(cm, 3),
                             "rot_pred": np.round(box.rotation, 4).tolist(),
                             "rot_head": np.round(head[i], 4).tolist(),
                             "rot_gt": np.round(rot_gt, 4).tolist()})
    finally:
        loader.close()
    return rows


def spread_args(argv):
    import argparse
    ap = argparse.ArgumentParser(prog="split_c17.py spread")
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0,
                    help="the duo instances, and the training runs' weights")
    ap.add_argument("--seeds", type=str, default="0,1,2,3,4",
                    help="the weight seeds of the comparison at init")
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--save_freq", type=int, default=100)
    ap.add_argument("--packages", type=str, default="jax,port,port_own")
    ap.add_argument("--out_dir", type=str, required=True)
    return ap.parse_args(argv)


def write_jax_start(cfg, jax_state, ckpt_dir: str) -> None:
    """A step-0 checkpoint of the port in ckpt_dir that holds the weights
    of a JAX TrainState (model and trunk, weight_convert's layouts), from
    which the port's Trainer of `cfg` resumes."""
    import jax
    from selfcorr_tpu_torch.models.meshnet import (MeshNet,
                                                   build_mesh_constants)
    from selfcorr_tpu_torch.models.vit import DinoViTS8
    from selfcorr_tpu_torch.train.step import init_state
    from selfcorr_tpu_torch.utils import checkpoint as ckpt
    from selfcorr_tpu_torch.utils import weight_convert as W
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pconst = build_mesh_constants(cfg)
    model = MeshNet(cfg, pconst)
    model.load_state_dict(W.from_jax_params(to_np(jax_state.params),
                                            to_np(jax_state.batch_stats)))
    dino = DinoViTS8(img_size=cfg.img_size, attn_bf16=cfg.dino_attn_bf16)
    dino.load_state_dict(W.from_jax_dino_params(
        to_np(jax_state.dino_params)))
    ckpt.save_state(ckpt_dir, init_state(cfg, pconst, "cpu", model=model,
                                         dino=dino), 0)


def jax_start(argv=None):
    """The `jax_start` subcommand (module docstring)."""
    import dataclasses
    import jax
    jax.config.update("jax_platforms", "cpu")
    from selfcorr_tpu.configs import Config as JConfig
    from selfcorr_tpu.models import meshnet as JM
    from selfcorr_tpu.train.step import init_state as jax_init_state
    from selfcorr_tpu_torch.data.synthetic import duo_prior_mesh
    from selfcorr_tpu_torch.ops.mesh_ops import save_obj
    from selfcorr_tpu_torch.tools import validate_synthetic as V
    args = V.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    prior = os.path.join(args.out_dir, "duo_prior.obj")
    save_obj(prior, *duo_prior_mesh(2))
    cfg = V.make_config(args, args.out_dir, prior)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)})
    state = jax_init_state(jcfg, JM.build_mesh_constants(jcfg),
                           jax.random.PRNGKey(cfg.seed))
    ckpt_dir = os.path.join(args.out_dir, cfg.name, "ckpt")
    write_jax_start(cfg, state, ckpt_dir)
    print(f"wrote the JAX init_state of seed {cfg.seed} as step 0 of "
          f"{ckpt_dir}", flush=True)


def compare_spreads(argv=None):
    """The `spread` subcommand (module docstring)."""
    import dataclasses
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    from selfcorr_tpu.configs import Config as JConfig
    from selfcorr_tpu.models import meshnet as JM
    from selfcorr_tpu.train.step import init_state as jax_init_state
    from selfcorr_tpu.utils import checkpoint as jckpt
    from selfcorr_tpu_torch.data.loader import BATCH_KEYS, TestLoader
    from selfcorr_tpu_torch.data.synthetic import (SyntheticTest,
                                                   duo_prior_mesh)
    from selfcorr_tpu_torch.models.init import init_model
    from selfcorr_tpu_torch.models.meshnet import (MeshNet,
                                                   build_mesh_constants,
                                                   forward_test)
    from selfcorr_tpu_torch.ops.mesh_ops import save_obj
    from selfcorr_tpu_torch.tools import validate_synthetic as V
    from selfcorr_tpu_torch.train.loop import Trainer
    from selfcorr_tpu_torch.utils import checkpoint as ckpt
    from selfcorr_tpu_torch.utils import weight_convert as W
    from selfcorr_tpu.train.loop import Trainer as TrainerJ
    from test_torch_slice import jitter_factors

    args = spread_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    prior = os.path.join(args.out_dir, "duo_prior.obj")
    save_obj(prior, *duo_prior_mesh(2))
    vargs = V.parse_args(["--img_size", str(args.img_size), "--device",
                          "cpu", "--seed", str(args.seed), "--iters",
                          str(args.iters), "--save_freq",
                          str(args.save_freq)])
    cfg = V.make_config(vargs, args.out_dir, prior)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)})
    pconst, jconst = build_mesh_constants(cfg), JM.build_mesh_constants(jcfg)
    ecfg = V.eval_config(cfg)
    loader = TestLoader(SyntheticTest(ecfg, num_videos=4,
                                      frames_per_video=24, seed=args.seed,
                                      shape="duo"), ecfg)
    batches = list(loader)
    loader.close()
    keys = [jax.random.fold_in(jax.random.PRNGKey(123), i)
            for i in range(len(batches))]
    valid = np.concatenate([b["valid"] for b in batches]).astype(bool)
    truth = np.concatenate([b["rot_gt"] for b in batches])[valid]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jfwd = jax.jit(lambda p, s, b, k: JM.forward_test(p, s, b, jconst, k,
                                                      jcfg)["rotation"])

    def jax_spread(params, stats):
        rots = [np.asarray(jfwd(params, stats, {k: np.asarray(
            b[k], np.float32) for k in BATCH_KEYS}, key))
            for b, key in zip(batches, keys)]
        return spread(np.concatenate(rots)[valid])

    def port_spread(model):
        model.eval()
        rots = []
        with torch.no_grad():
            for b, key in zip(batches, keys):
                tb = {k: torch.as_tensor(np.asarray(b[k], np.float32))
                      for k in BATCH_KEYS}
                rots.append(forward_test(model, tb, pconst, cfg,
                                         jitter=jitter_factors(key))[
                                             "rotation"].numpy())
        return spread(np.concatenate(rots)[valid])

    def jax_weights(seed):
        st = jax_init_state(jcfg, jconst, jax.random.PRNGKey(seed))
        model = MeshNet(cfg, pconst)
        model.load_state_dict(W.from_jax_params(to_np(st.params),
                                                to_np(st.batch_stats)))
        return st, model

    def emit(line):
        print(json.dumps(line), flush=True)
        with open(os.path.join(args.out_dir, "spread.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")

    emit({"frames": int(valid.sum()), "truth_spread_deg": round(
        spread(truth), 2)})
    for seed in [int(x) for x in args.seeds.split(",") if x]:
        st, model = jax_weights(seed)
        emit({"init_seed": seed, "jax": round(jax_spread(
            st.params, st.batch_stats), 2),
              "jax_in_port": round(port_spread(model), 2),
              "port_own": round(port_spread(init_model(
                  cfg.replace(seed=seed), pconst)), 2)})
    if not args.iters:
        return
    saves = [0] + list(range(args.save_freq, args.iters + 1,
                             args.save_freq))
    for package in args.packages.split(","):
        run = cfg.replace(name=f"spread-{package}")
        ckpt_dir = os.path.join(args.out_dir, run.name, "ckpt")
        st0 = jax_weights(args.seed)[0]
        if package == "jax":
            trainer = TrainerJ(JConfig(**{
                f.name: getattr(run, f.name)
                for f in dataclasses.fields(JConfig)}))
            trainer.train()
            for s in saves:
                st = st0 if s == 0 else jckpt.restore_state(
                    ckpt_dir, trainer.state, step=s)
                emit({"package": package, "step": s, "head_spread_deg":
                      round(jax_spread(st.params, st.batch_stats), 2)})
            continue
        if package == "port":      # from JAX's weights: a step-0 checkpoint
            write_jax_start(run, st0, ckpt_dir)
        Trainer(run).train()
        for s in saves:
            if s == 0 and package == "port_own":
                model = init_model(run, pconst)
            else:
                model = MeshNet(cfg, pconst)
                model.load_state_dict(ckpt.restore_raw(ckpt_dir, s)["model"])
            emit({"package": package, "step": s,
                  "head_spread_deg": round(port_spread(model), 2)})


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["spread"]:
        return compare_spreads(argv[1:])
    if argv[:1] == ["jax_start"]:
        return jax_start(argv[1:])
    from selfcorr_tpu_torch.tools import validate_synthetic as V
    args = V.parse_args(argv)
    if not args.out_dir:
        raise SystemExit("split_c17.py needs --out_dir")
    V.run(args)
    cfg = V.make_config(args, args.out_dir,
                        os.path.join(args.out_dir, "duo_prior.obj"))
    rows = frames(V.eval_config(cfg),
                  os.path.join(args.out_dir, cfg.name, "ckpt"), args.seed)
    with open(os.path.join(args.out_dir, f"{cfg.name}-frames.jsonl"),
              "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    for v in sorted({r["video"] for r in rows}):
        print(json.dumps({"video": v, **summarize(
            [r for r in rows if r["video"] == v])}))
    print(json.dumps({"video": "all", **summarize(rows)}), flush=True)


if __name__ == "__main__":
    main()
