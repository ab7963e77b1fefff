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

It imports only the port (it runs where JAX is not installed). It is a
script, not a test (pytest does not collect it);
tests/test_torch_tools.py tests split_rotation.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


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


def spread(rots) -> float:
    """The median angle (degrees) of rotations (N, 3, 3) to their chordal
    mean (the SVD projection of their average onto the rotations)."""
    rots = np.asarray(rots, np.float64)
    u, _, vt = np.linalg.svd(rots.mean(0))
    mean = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    return float(np.median([_angle((np.trace(mean.T @ r) - 1) / 2)
                            for r in rots]))


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


def main(argv=None):
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
