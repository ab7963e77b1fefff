"""The learning check on the asymmetric synthetic task (the port's
counterpart of scripts/validate_synthetic.py, with its flags and outputs).

Trains from scratch on the procedural two-lobe ('duo') videos, which are
rotationally unambiguous, so the NOCS deg / cm buckets are exercised and
not only IoU, with the matching duo shape prior (an identifiable canonical
frame). Then it evaluates the full pipeline (correspondence -> RANSAC-
Umeyama fit -> exact 3D IoU and deg / cm against the ray tracer's exact
poses) on the training instances at held-out frames. Ablations zero the
named loss weights:

  python -m selfcorr_tpu_torch.tools.validate_synthetic --iters 1000
  python -m selfcorr_tpu_torch.tools.validate_synthetic --iters 1000 \
      --ablate match,imatch
  python -m selfcorr_tpu_torch.tools.validate_synthetic --img_size 256 \
      --iters 1000 --warm_start_path <run>/<name>/ckpt

It prints one JSON line per --eval_steps checkpoint (appended to
<out_dir>/<name>-trajectory.jsonl), then the final line (written to
<out_dir>/<name>-results.json). Runs on CUDA unless --device cpu is given;
a missing GPU is an error. --platform is parsed and ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

ABLATABLE = {
    "match": "match_wt", "imatch": "imatch_wt", "cycle": "cycle_loss_wt",
    "cycle_pretrain": "cycle_loss_pretrain_wt", "tex": "tex_wt",
    "depth": "depth_wt", "symmetry": "symmetry_wt",
}

# the --set coercions by the Config field's declared type
_CASTS = {("bool", bool): lambda s: s.lower() in ("1", "true"),
          ("int", int): int, ("float", float): float, ("str", str): str}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--ablate", type=str, default="",
                    help="comma list: " + ",".join(ABLATABLE))
    ap.add_argument("--platform", type=str, default="",
                    help="parsed and ignored (the JAX package's backend)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--img_size", type=int, default=256)
    ap.add_argument("--name", type=str, default="")
    ap.add_argument("--out_dir", type=str, default="")
    ap.add_argument("--eval_only", action="store_true",
                    help="skip training; evaluate out_dir/<name>/ckpt")
    ap.add_argument("--freeze_prior", action="store_true",
                    help="prior_deform=False: anchor the canonical frame to "
                         "the duo prior (identifiable rotations)")
    ap.add_argument("--iters_eval_stride", type=int, default=2,
                    help="parsed; unused, as in the JAX script")
    ap.add_argument("--seed", type=int, default=0,
                    help="synthetic instance-family seed (different seeds "
                         "are different object instances)")
    ap.add_argument("--vis_freq", type=int, default=10 ** 9,
                    help="image-panel cadence of the training log")
    ap.add_argument("--save_freq", type=int, default=500)
    ap.add_argument("--eval_steps", type=str, default="",
                    help="comma list of saved checkpoint steps to evaluate "
                         "besides the final state: one JSON line per step "
                         "(the metric trajectory)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE",
                    help="Config override (repeatable), coerced to the "
                         "field's declared type, e.g. --set dino_bf16=1")
    ap.add_argument("--warm_start_path", type=str, default="",
                    help="checkpoint directory of an earlier port run: the "
                         "encoder (backbone and FPN) starts from it")
    return ap.parse_args(argv)


def run_name(args) -> str:
    return args.name or ("duo"
                         + ("-frozen" if args.freeze_prior else "")
                         + ("-warm" if args.warm_start_path else "")
                         + (f"-seed{args.seed}" if args.seed else "")
                         + ("-" + args.ablate if args.ablate else ""))


def make_config(args, run_dir: str, prior_path: str):
    """The training Config of the JAX script, field for field; use_pallas
    (parsed and ignored by the port) follows the device as the JAX
    script's follows its backend. Raises KeyError for an unknown --ablate
    or --set name and ValueError for a --set field of another type than
    bool, int, float or str."""
    from selfcorr_tpu_torch.configs import Config
    small = args.img_size <= 64
    cfg = Config(
        dataset_name="synthetic", synthetic_shape="duo",
        img_size=args.img_size,
        corr_h=args.img_size // 4, corr_w=args.img_size // 4,
        batch_size=8 if not small else 2, repeat=4 if not small else 2,
        total_iters=args.iters, learning_rate=1e-4,
        depth_offset=5.0, use_depth=True, divide_fn="both",
        pretrain_k=200 if not small else 8,
        codedim=64 if not small else 8,
        n_corr_feat=64 if not small else 16,
        symmetry_idx=-1,                 # asymmetric shape: no symmetry
        shape_prior=True, shape_prior_path=prior_path,
        prior_deform=not args.freeze_prior,
        mask_wt=0.15, tex_wt=0.05, depth_wt=0.1, triangle_wt=0.002,
        pullfar_wt=0.01, deform_wt=0.4, symmetry_wt=0.0, camera_wt=0.005,
        match_wt=0.02, imatch_wt=0.02, decay_ratio=0.1,
        cycle_loss_wt=0.01, cycle_loss_pretrain_wt=0.02,
        vert_lr_ratio=0.01, cam_lr_ratio=0.1,
        use_pallas=args.device != "cpu",
        checkpoint_dir=run_dir, name=run_name(args),
        save_freq=args.save_freq, vis_freq=args.vis_freq,
        batch_log_interval=50,
        num_workers=4, seed=args.seed,
        warm_start_path=args.warm_start_path,
        device=args.device,
    )
    for key in [k for k in args.ablate.split(",") if k]:
        cfg = cfg.replace(**{ABLATABLE[key]: 0.0})
    types = {f.name: f.type for f in dataclasses.fields(cfg)}
    for kv in args.overrides:
        k, _, v = kv.partition("=")
        t = types[k]
        cast = next((f for key, f in _CASTS.items() if t in key), None)
        if cast is None:
            raise ValueError(
                f"--set {k}: field type {t!r} is not overridable here "
                f"(only bool/int/float/str fields are)")
        cfg = cfg.replace(**{k: cast(v)})
    return cfg


def eval_config(cfg):
    """The evaluation's Config of a training Config from make_config: the
    NOCS metrics on every second frame, batch 8 (4 for img_size <= 64)."""
    return cfg.replace(train=False, eval=True, eval_nocs=True,
                       batch_size=8 if cfg.img_size > 64 else 4, repeat=1,
                       dframe_eval=2, name=cfg.name + "-eval")


def evaluate(cfg, model_path: str, seed: int) -> dict:
    """The NOCS metrics of the checkpoint at model_path (a run's ckpt
    directory, its latest step, or one step's directory) on the duo test
    videos: the 4 training instances at every second frame of 24, batch 8
    (4 for img_size <= 64). A fresh Tester each time, so each line's draws
    do not depend on the evaluations before it."""
    from selfcorr_tpu_torch.data.synthetic import SyntheticTest
    from selfcorr_tpu_torch.eval.tester import Tester
    tester = Tester(cfg.replace(model_path=model_path))
    dataset = SyntheticTest(tester.cfg, num_videos=4, frames_per_video=24,
                            seed=seed, shape="duo")
    return tester.test(dataset)


def run(args):
    """Train (unless --eval_only), then evaluate. Returns (the final line,
    the trajectory lines, the Trainer or None)."""
    from selfcorr_tpu_torch.data.synthetic import duo_prior_mesh
    from selfcorr_tpu_torch.ops.mesh_ops import save_obj
    from selfcorr_tpu_torch.utils import checkpoint as ckpt
    from selfcorr_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    run_dir = args.out_dir or tempfile.mkdtemp(prefix="valsynth_")
    os.makedirs(run_dir, exist_ok=True)
    prior_path = os.path.join(run_dir, "duo_prior.obj")
    save_obj(prior_path, *duo_prior_mesh(2))
    cfg = make_config(args, run_dir, prior_path)
    name = cfg.name

    trainer = None
    if not args.eval_only:
        from selfcorr_tpu_torch.train.loop import Trainer
        trainer = Trainer(cfg)
        trainer.train()

    ckpt_dir = os.path.join(run_dir, name, "ckpt")
    tcfg = eval_config(cfg)
    trajectory = []
    for s in [int(x) for x in args.eval_steps.split(",") if x]:
        r = evaluate(tcfg, os.path.join(ckpt_dir, str(s)), args.seed)
        line = {"name": name, "iters": s, "trajectory": True,
                **{k: round(float(v), 4) for k, v in r.items()}}
        print(json.dumps(line), flush=True)
        with open(os.path.join(run_dir, f"{name}-trajectory.jsonl"),
                  "a") as f:
            f.write(json.dumps(line) + "\n")
        trajectory.append(line)
    results = evaluate(tcfg, ckpt_dir, args.seed)

    iters = args.iters if not args.eval_only else ckpt.latest_step(ckpt_dir)
    out = {"name": name, "iters": iters, "ablate": args.ablate,
           **{k: round(float(v), 4) for k, v in results.items()}}
    print(json.dumps(out), flush=True)
    with open(os.path.join(run_dir, f"{name}-results.json"), "w") as f:
        json.dump(out, f)
    return out, trajectory, trainer


def main(argv=None) -> dict:
    """Returns the final line."""
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
