"""A run of a cell at a size a CPU test can hold: the cell's files, with
the widths cut (a test size, never a cell's) and the port's plain versions
in place of its kernels."""
from __future__ import annotations

import contextlib
import io
import json

import torch

TINY = dict(img_size=32, corr_h=8, corr_w=8, batch_size=2, repeat=2,
            n_corr_feat=16, codedim=8, symmetry_npts=256, pretrain_k=8,
            ransac_iters=8, pose_fit_max_points=512, device="cpu")


def tiny_run(workload: str, seed: int = 123456789012, seconds: float = 0.5):
    """(exit code, the result line as a dict or None, standard error) of
    benchmark/run.py's main on the CPU at the tiny size."""
    from benchmark import run
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      device=torch.device("cpu"), flag_overrides=TINY)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
