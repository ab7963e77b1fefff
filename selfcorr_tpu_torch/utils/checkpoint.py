"""Checkpoints of the full train state (counterpart of
selfcorr_tpu/utils/checkpoint.py).

Layout as orbax's CheckpointManager writes it: one directory a step,
`ckpt_dir/<step>/state.pt`, none pruned. A checkpoint holds the model's
whole state_dict (parameters, mesh.mean_v, every BatchNorm buffer), the
optimizer's five AdamW groups (moments and per-parameter step counts),
TrainState.step and the frozen DINO trunk's weights, once, in the trunk's
dtype (bfloat16 under --dino_bf16). It holds only
tensors, Python numbers, strings, None and dicts, lists or tuples of them,
so it loads with torch.load(weights_only=True).

A save writes `state.pt.tmp` in the step's directory, flushes it to disk and
renames it into place, so a run killed while saving leaves no `state.pt`
for latest_step to pick. Across ranks the state is replicated: rank 0
writes it and the others wait at a barrier (train/loop.py Trainer.save),
and every rank restores from the same directory.
"""
from __future__ import annotations

import os

import torch

FILE = "state.pt"


def save_state(ckpt_dir: str, state, step: int) -> str:
    """Write `state` (a train.step.TrainState) as step `step`; returns the
    file's path."""
    step_dir = os.path.join(ckpt_dir, str(step))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, FILE)
    payload = {"step": int(state.step),
               "model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "dino": state.dino.state_dict()}
    with open(path + ".tmp", "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    """The largest step with a complete checkpoint in ckpt_dir, or None
    (also for a missing directory)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n) for n in os.listdir(ckpt_dir) if n.isdigit()
             and os.path.isfile(os.path.join(ckpt_dir, n, FILE))]
    return max(steps, default=None)


def checkpoint_file(path: str, step: int | None = None) -> str:
    """The checkpoint file of `path`: a step directory, or a checkpoint
    directory (its step `step`, by default the latest)."""
    if step is None and os.path.isfile(os.path.join(path, FILE)):
        return os.path.join(path, FILE)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {path!r}")
    file = os.path.join(path, str(step), FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint of step {step} in {path!r}")
    return file


def restore_raw(path: str, step: int | None = None) -> dict:
    """A checkpoint as stored, on the CPU: {"step", "model", "optimizer",
    "dino"}. Nothing is shape-checked, so a source written at another
    img_size (a DINO pos_embed of another length) loads."""
    return torch.load(checkpoint_file(path, step), map_location="cpu",
                      weights_only=True)


def restore_state(path: str, state, step: int | None = None):
    """Load a checkpoint into `state` in place (model, DINO trunk,
    optimizer, step) and return it. The tensors are read to the CPU and
    copied into the state's own, so a trunk saved in one dtype is cast to
    the run's (float32 to bfloat16 rounds it as init_state does with
    --dino_bf16); AdamW's load_state_dict moves the moments
    to the parameters' device and leaves each `step` count on the CPU, where
    a fresh AdamW keeps it."""
    raw = restore_raw(path, step)
    state.model.load_state_dict(raw["model"])
    state.dino.load_state_dict(raw["dino"])
    state.optimizer.load_state_dict(raw["optimizer"])
    state.step = raw["step"]
    return state
