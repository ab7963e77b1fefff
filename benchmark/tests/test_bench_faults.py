"""A run with the timed path broken underneath sees `correct` come out
false, through the number that the fault moves: on the CPU at a tiny
size, past the look for a card. One chip, so no exchange between chips
can be left out."""
from __future__ import annotations

import pytest
import torch

from benchmark.tests.bench_tiny import tiny_run


def _failed(line, number):
    assert line["correct"] is False
    got = line["checked"][number]
    assert got["value"] > got["limit"], line["checked"]


def test_sound_runs_pass():
    for w in ("laptop_train", "laptop_predict"):
        rc, line, err = tiny_run(w)
        assert rc == 0 and line["correct"] is True, err[-2000:]


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    from selfcorr_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "step", lambda self, count: None)
    rc, line, err = tiny_run("laptop_train")
    assert rc == 0, err[-2000:]
    _failed(line, "change_gap")
    assert line["checked"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    """The step sees the first half of its videos; its losses are the
    mean over those rows."""
    import selfcorr_tpu_torch.train.step as step_mod
    real = step_mod.train_step

    def half(state, batch, draws, cfg, group=None):
        rows = batch["img"].shape[0] // 2
        cut = {k: v[:rows] for k, v in batch.items()}
        d = draws._replace(**{k: getattr(draws, k)[:rows]
                              for k in ("sym_u", "sym_ub")})
        return real(state, cut, d, cfg.replace(
            batch_size=cfg.batch_size // 2), group)
    monkeypatch.setattr(step_mod, "train_step", half)
    rc, line, err = tiny_run("laptop_train")
    assert rc == 0, err[-2000:]
    _failed(line, "cont_loss_rel")


@pytest.mark.parametrize("key,number", [("translation", "trans_mm"),
                                        ("rotation", "rot_deg")])
def test_answer_altered_where_produced(monkeypatch, key, number):
    """One frame's fitted pose moved as fit_poses returns it."""
    from selfcorr_tpu_torch.eval import tester
    real = tester.fit_poses

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        moved = out[key].clone()
        if key == "rotation":
            c, s = torch.cos(torch.tensor(0.01)), torch.sin(torch.tensor(0.01))
            turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            moved[0] = turn @ moved[0]
        else:
            moved[0] += 0.01
        return {**out, key: moved}
    monkeypatch.setattr(tester, "fit_poses", altered)
    rc, line, err = tiny_run("laptop_predict")
    assert rc == 0, err[-2000:]
    _failed(line, number)
