"""The numbers that decide `correct`, each held to the cell's limit
(limits/<workload>.json).

Training (the first three steps through the window's own call, against
the reference's three steps from the same weights, batches and draws):
  loss_rel     the largest |loss - reference| / |reference| of the three
               steps' total loss;
  grad_gap     the worst leaf's |norm of the program's first gradient as
               the optimizer took it (AdamW's first moment after one step
               over 1 - beta1) - norm of the reference's| over the larger
               of the reference leaf's norm and the median leaf's;
  change_gap   the same of each leaf's change over the three steps, over
               the leaves whose reference gradient is at least a
               thousandth of the median leaf's (the others move under Adam
               by round-off alone).
Predict (every answer of the run against the reference's answer to the
same batch and draws):
  rot_deg      the largest angle between a fitted rotation and the
               reference's;
  trans_mm     the largest distance between fitted translations, in mm;
  box_mm       the largest distance between corresponding corners of the
               fitted 3D boxes, in mm;
  ok_flips     frames whose fit succeeded on one side only (limit 0).
Both: launches_off, units whose kernel launches differ from what the
traffic's layers need (limit 0).
"""
from __future__ import annotations

import math

import torch

GRAD_FLOOR = 1e-3     # of the median leaf's reference gradient norm


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


# the loss terms whose value follows the weights continuously; the DINO
# pair matches of cycle_loss_pretrain and the rotation cycle's argmax
# select discretely
DISCRETE_TERMS = ("cycle_loss_pretrain", "cycle_loss")


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def train_numbers(prog_aux: list, ref_aux: list, prog_grad: dict,
                  ref_grad: dict, prog_change: dict,
                  ref_change: dict) -> tuple:
    """(numbers, notes): prog_aux / ref_aux hold each checked step's
    {loss term: value}, total_loss among them."""
    def cont(aux):
        return sum(v for k, v in aux.items()
                   if k != "total_loss" and k not in DISCRETE_TERMS)
    numbers = {
        "loss_rel": max(_rel(p["total_loss"], r["total_loss"])
                        for p, r in zip(prog_aux, ref_aux)),
        "loss1_rel": _rel(prog_aux[0]["total_loss"],
                          ref_aux[0]["total_loss"]),
        "cont_loss_rel": max(_rel(cont(p), cont(r))
                             for p, r in zip(prog_aux, ref_aux)),
    }
    names = sorted(prog_grad)
    g = _gaps(prog_grad, ref_grad, names)
    gn = _norms({k: ref_grad[k] for k in names})
    floor = GRAD_FLOOR * _median(list(gn.values()))
    moved = [k for k in names if gn[k] >= floor]
    c = _gaps(prog_change, ref_change, moved)
    numbers.update(grad_gap=max(g.values()), grad_gap_median=_median(
        list(g.values())), change_gap=max(c.values()),
        change_gap_median=_median(list(c.values())))
    notes = {
        "step 1 terms, relative gap": {
            k: _rel(prog_aux[0][k], v) for k, v in ref_aux[0].items()},
        "worst grad leaf": max(g, key=g.get),
        "worst change leaf": max(c, key=c.get),
        "leaves left out of the change": sorted(set(names) - set(moved))}
    return numbers, notes


def _gaps(prog: dict, ref: dict, names) -> dict:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), median leaf norm
    of ref)}."""
    pn = _norms({k: prog[k] for k in names})
    rn = _norms({k: ref[k] for k in names})
    floor = _median(list(rn.values()))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in names}


def rot_angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angles between rotations (..., 3, 3), well conditioned near 0:
    2 asin(|A - B|_F / sqrt(8))."""
    d = torch.linalg.matrix_norm((a - b).double())
    return torch.rad2deg(2.0 * torch.asin(torch.clamp(d / math.sqrt(8.0),
                                                      max=1.0)))


def predict_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: the answers of one batch (host tensors), over every
    frame: a frame whose fit failed holds the fallback pose on both sides
    or counts in ok_flips."""
    ok = (prog["ok"] != ref["ok"]).sum()
    rot = rot_angle_deg(prog["rotation"], ref["rotation"])
    trans = torch.linalg.vector_norm(
        (prog["translation"] - ref["translation"]).double(), dim=-1)[:, 0]
    box = torch.linalg.vector_norm(
        (prog["bbox9"] - ref["bbox9"]).double(), dim=-1).amax(-1)

    def worst(x):
        return float(x.max()) if x.numel() else 0.0
    return {"rot_deg": worst(rot), "trans_mm": 1000.0 * worst(trans),
            "box_mm": 1000.0 * worst(box), "ok_flips": int(ok)}


def merge_worst(acc: dict, new: dict) -> dict:
    return {k: max(acc.get(k, v), v) for k, v in new.items()}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): correct when every number is
    finite and at most its limit, and every limit has its number."""
    rows = [(k, numbers.get(k, math.nan), limits[k]) for k in limits]
    ok = all(isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
