"""Five-group AdamW with per-group OneCycle learning rates, per-group
gradient clipping and the NaN guard (counterpart of
selfcorr_tpu/train/optim.py).

Groups and peak learning rates (optim.py:73-79): vert (mesh.mean_v, lr x
vert_lr_ratio), cam (pose_predictor, lr x cam_lr_ratio), shape
(shape_code_predictor + shape_predictor), feat (featnet + featnet_mesh),
backbone. AdamW betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on every
parameter of a group. BatchNorm scale and bias are in no group (the JAX
package labels them 'frozen': no update, no decay), nor is mean_v when a
shape prior is used without prior_deform.

The learning rate is optax.cosine_onecycle_schedule evaluated at the count
of updates so far, as optax's scale_by_schedule does; it is set on each
group before each update. On a non-finite gradient the guard zeroes every
gradient and the update still runs: the moments decay, the weight decay
applies and the count advances, as in the JAX step.
"""
from __future__ import annotations

import math

import torch

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.models.resnet import BatchNorm

GROUP_OF_MODULE = {
    "backbone": "backbone",
    "featnet": "feat",
    "featnet_mesh": "feat",
    "shape_code_predictor": "shape",
    "shape_predictor": "shape",
    "pose_predictor": "cam",
}
GROUPS = ("vert", "cam", "shape", "feat", "backbone")


def onecycle_lr(peak_lr: float, total_steps: int, count: int) -> float:
    """optax.cosine_onecycle_schedule(transition_steps=total_steps,
    peak_value=peak_lr, pct_start, div_factor=25, final_div_factor=25)
    at `count`, with the JAX package's pct_start rule (optim.py:62-68):
    cosine from peak/25 up to peak over the first pct_start of the steps,
    then down to peak/625, flat after."""
    pct_start = max(0.05, 1.001 / max(total_steps, 2))
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    values = (peak_lr / 25.0, peak_lr, peak_lr / 625.0)
    for i in range(2):
        if bounds[i] <= count < bounds[i + 1]:
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            start, end = values[i], values[i + 1]
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
    return values[-1]


def peak_lrs(cfg: Config) -> dict:
    return {"vert": cfg.vert_lr_ratio * cfg.learning_rate,
            "cam": cfg.cam_lr_ratio * cfg.learning_rate,
            "shape": cfg.learning_rate, "feat": cfg.learning_rate,
            "backbone": cfg.learning_rate}


def param_groups(model, cfg: Config) -> dict:
    """{group: [(name, parameter)]} for a models.meshnet.MeshNet; frozen
    parameters (BatchNorm, a non-deforming prior's mean_v) are left out."""
    frozen = {id(p) for m in model.modules() if isinstance(m, BatchNorm)
              for p in m.parameters(recurse=False)}
    train_mean_v = (not cfg.shape_prior) or cfg.prior_deform
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if id(p) in frozen:
            continue
        if name == "mesh.mean_v":
            if train_mean_v:
                groups["vert"].append((name, p))
            continue
        top = name.split(".")[1]            # encoder.<module>.<...>
        groups[GROUP_OF_MODULE.get(top, "feat")].append((name, p))
    return groups


class Optimizer:
    """torch.optim.AdamW over the five groups, with the OneCycle schedule
    set per group before each update."""

    def __init__(self, model, cfg: Config):
        self.cfg = cfg
        self.peaks = peak_lrs(cfg)
        self.groups = param_groups(model, cfg)
        self.names = [g for g in GROUPS if self.groups[g]]
        self.adamw = torch.optim.AdamW(
            [{"params": [p for _, p in self.groups[g]], "lr": 0.0}
             for g in self.names],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

    def lrs(self, count: int) -> dict:
        return {g: onecycle_lr(self.peaks[g], self.cfg.total_iters, count)
                for g in self.names}

    def step(self, count: int) -> None:
        """One AdamW update with the learning rates at `count` (the number
        of updates before this one)."""
        lrs = self.lrs(count)
        for group, g in zip(self.adamw.param_groups, self.names):
            group["lr"] = lrs[g]
        self.adamw.step()

    def state_dict(self) -> dict:
        """The five groups' names, in order, and AdamW's state: each
        parameter's moments and step count. The learning rates are not
        state: step(count) derives them from the train state's step."""
        return {"groups": list(self.names), "adamw": self.adamw.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Load a state_dict() of an Optimizer over the same groups;
        raises ValueError if its groups differ (another cfg)."""
        if list(sd["groups"]) != self.names:
            raise ValueError(f"checkpoint optimizer groups {sd['groups']} "
                             f"differ from this model's {self.names}")
        self.adamw.load_state_dict(sd["adamw"])


def _group_norm(grads, device) -> torch.Tensor:
    """Global norm of `grads`, from one multi-tensor norm launch (0 for an
    empty group, as for a --no_deform shape predictor)."""
    if not grads:
        return torch.zeros((), device=device)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_and_guard(model) -> tuple:
    """Per-group clipping, then the global NaN guard, in place on the
    gradients and on the device (no host sync), in a few multi-tensor
    launches: mean_v to norm 1, shape_predictor to 1, pose_predictor to
    0.1; then, if any gradient of any parameter is not finite, every
    gradient becomes zero. The guard reads every gradient once, from one
    flat copy: it is zeroed where a value is not finite (a fill, since
    NaN x 0 is NaN) and copied back.

    Returns (norms {grad_meanv_norm, grad_shapenerf_norm,
    grad_pose_predictor_norm}, before clipping; bad (), True when the guard
    fired)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    enc = model.encoder
    norms = {}
    for key, params_g, max_norm in (
            ("grad_meanv_norm", [model.mesh.mean_v], 1.0),
            ("grad_shapenerf_norm", list(enc.shape_predictor.parameters()),
             1.0),
            ("grad_pose_predictor_norm", list(enc.pose_predictor.parameters()),
             0.1)):
        grads_g = [p.grad for p in params_g if p.grad is not None]
        norm = _group_norm(grads_g, model.mesh.mean_v.device)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
        if grads_g:
            torch._foreach_mul_(grads_g, scale)
        norms[key] = norm
    flat = torch.cat([g.reshape(-1) for g in grads])
    bad = ~torch.isfinite(flat).all()
    flat.masked_fill_(bad, 0.0)
    pieces = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(pieces, grads)])
    return norms, bad
