"""The entry points of the port at --num_devices 2 on the CPU: two gloo
ranks, each in its own process, at the port tests' small size (img 32,
corr 8^2).

(d) Training: 2 steps with finite losses, rank 0 alone printing and
writing; a second call resumes; with the loader's worker processes too
(grandchildren of the spawned ranks).
(e) Evaluation: two ranks give one rank's six NOCS metrics, padded tail
batch included, and every rank returns the whole run's summary;
--eval_cub refuses several ranks.
A rank that raises ends the run. Every subprocess has a timeout.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from selfcorr_tpu_torch import parallel as P
from selfcorr_tpu_torch.configs import Config
from test_torch_threads import share_cores  # noqa: F401 (autouse)
from test_torch_threads import thread_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
LAPTOP = os.path.join(ROOT, "config/wild6d/laptop.txt")
RANKS = 2
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
    [ROOT, TESTS] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
           **thread_env())


def in_subprocess(code: str, timeout: int = 600):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


TINY_ARGS = ["--flagfile", LAPTOP, "--dataset_name", "synthetic",
             "--img_size", "32", "--corr_h", "8", "--corr_w", "8",
             "--pretrain_k", "8", "--n_corr_feat", "16", "--codedim", "8",
             "--symmetry_npts", "256", "--device", "cpu"]


def entry(module: str, args, timeout: int = 600) -> str:
    out = subprocess.run([sys.executable, "-m", module, *TINY_ARGS, *args],
                         cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("extra", [[], ["--loader_processes",
                                        "--num_workers", "1"]],
                         ids=["threads", "processes"])
def test_train_entry_point_two_ranks(extra, tmp_path):
    """Two CPU ranks train 2 steps with finite losses; rank 0 alone prints
    and writes the config snapshot, the scalar log and the checkpoint; a
    second call resumes from it (threads case). With the loader's worker
    processes each rank starts its own (grandchildren of the launcher)."""
    args = ["--num_devices", "2", "--batch_size", "2", "--repeat", "2",
            "--batch_log_interval", "1", "--checkpoint_dir", str(tmp_path),
            *extra]
    out = entry("selfcorr_tpu_torch.train", args + ["--total_iters", "2"])
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("iter ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert out.count("[train] scalars go to") == 1
    run = tmp_path / "exp"
    names = sorted(os.listdir(run))
    assert names[:2] == ["ckpt", "config.txt"] and len(names) == 3, names
    assert names[2].startswith("events.out.tfevents"), names
    assert os.listdir(run / "ckpt") == ["2"]
    if extra:
        return      # the resume is the threads case's
    out = entry("selfcorr_tpu_torch.train", args + ["--total_iters", "3"])
    assert out.count("resuming from checkpoint step 2") == 1, out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("iter ")] == ["3/3"], out
    assert sorted(os.listdir(run / "ckpt")) == ["2", "3"]


NOCS_KEYS = ("iou@25", "iou@50", "5deg2cm", "5deg5cm", "10deg2cm",
             "10deg5cm")


def printed_metrics(out: str) -> dict:
    return {k: float(v) for k, v in re.findall(
        r"^(\S+): (\S+)$", out, re.M) if k in NOCS_KEYS}


def test_predict_entry_point_two_ranks_equals_one(tmp_path):
    """The synthetic eval set (12 frames) in batches of 8, the tail padded
    (rank 1's tail rows are all padding): two ranks print the six NOCS
    metrics of one rank."""
    args = ["--eval", "--eval_nocs", "--batch_size", "8", "--dframe_eval",
            "1", "--ransac_iters", "8", "--pose_fit_max_points", "512",
            "--checkpoint_dir", str(tmp_path)]
    got = {n: printed_metrics(entry("selfcorr_tpu_torch.predict",
                                    args + ["--num_devices", str(n)]))
           for n in (1, 2)}
    assert set(got[1]) == set(NOCS_KEYS) and got[1]["iou@25"] > 0, got
    assert got[2] == got[1]


def _eval_rank(rank: P.Rank, args, out: str):
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.eval.tester import Tester
    results = Tester(parse_args(args).replace(train=False), rank=rank).test()
    with open(f"{out}{rank.rank}.json", "w") as f:
        json.dump(results, f)


def run_eval_ranks(args, out: str):
    P.run_ranks(_eval_rank, P.Layout(RANKS, 0, ("cpu",) * RANKS), args, out)


def test_two_rank_tester_summary_equals_one_rank(tmp_path):
    """Every rank returns the whole run's summary, and it is the one-rank
    run's: the six NOCS metrics and the count exactly, the medians of the
    IoU and of the pose errors within 1e-4 (the forward on 4 rows rounds
    otherwise than on 8). A rank that thresholded the match confidence at
    its own rows' mean, not the whole batch's, moves the fits and the
    medians by about 1e-2."""
    from selfcorr_tpu_torch import predict
    args = [*TINY_ARGS, "--eval", "--eval_nocs", "--batch_size", "8",
            "--dframe_eval", "1", "--ransac_iters", "8",
            "--pose_fit_max_points", "512", "--checkpoint_dir",
            str(tmp_path)]
    one = predict.main(["predict"] + args)
    out = str(tmp_path / "rank")
    in_subprocess(f"import test_torch_parallel_entry as T; T.run_eval_ranks("
                  f"{args + ['--num_devices', str(RANKS)]!r}, {out!r})")
    got = []
    for r in range(RANKS):
        with open(f"{out}{r}.json") as f:
            got.append(json.load(f))
    assert got[1] == got[0]
    assert {k: got[0][k] for k in NOCS_KEYS + ("count",)} == {
        k: one[k] for k in NOCS_KEYS + ("count",)}
    for k in ("median_iou", "median_deg", "median_cm"):
        np.testing.assert_allclose(got[0][k], one[k], rtol=1e-4, err_msg=k)


def test_eval_cub_refuses_several_ranks(tmp_path):
    from selfcorr_tpu_torch.eval.tester import Tester
    cfg = Config(device="cpu", eval_cub=True, num_devices=2,
                 checkpoint_dir=str(tmp_path))
    rank = P.Rank(0, 2, torch.device("cpu"), None)
    with pytest.raises(NotImplementedError, match="eval_cub"):
        Tester(cfg, rank=rank)


def _fail_on_rank_1(rank: P.Rank):
    if rank.rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.all_reduce(torch.zeros(1))   # rank 0 waits for it


def run_failing_ranks():
    P.run_ranks(_fail_on_rank_1, P.Layout(RANKS, 0, ("cpu",) * RANKS))


def test_a_failing_rank_ends_the_run():
    """Rank 1 raises while rank 0 waits in a collective: the run ends with
    a rank's error (rank 1's, or rank 0's lost peer, whichever the launcher
    sees first) long before the group's timeout."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_parallel_entry as T; "
         "T.run_failing_ranks()"], cwd=ROOT, env=ENV, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "ProcessRaisedException" in out.stderr, out.stderr[-3000:]
    assert time.time() - t0 < P.DEFAULT_TIMEOUT.total_seconds() / 4
