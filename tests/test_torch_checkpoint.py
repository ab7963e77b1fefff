"""Checkpoints, auto-resume and scalar logging of the port's training loop
(selfcorr_tpu_torch/utils/{checkpoint,logging}.py, train/loop.py), on the
CPU at the port tests' small shapes (img 32, corr 8^2, icosphere(1), batch
2 x 2).

Resume is exact: two straight train steps equal one step, a save, a resume
in a fresh Trainer and one more step, bit for bit, on the same two batches
and the draws of step_generator(seed, 0 | 1). As in the JAX package, a
resumed process starts the dataset's sample stream afresh, so the resumed
Trainer's own loader yields the batches of a fresh run's first steps. The
scalar log and config.txt are held against selfcorr_tpu/utils/logging.py.

straight_and_resumed and state_tensors are also used by
tests/test_torch_cuda.py, which runs the same case on the card; so this file
imports the JAX package only inside the tests that compare with it.
"""
import contextlib
import copy
import io
import os

import pytest
import torch

from selfcorr_tpu_torch.configs import parse_args
from selfcorr_tpu_torch.data.loader import stack_items
from selfcorr_tpu_torch.eval.tester import Tester
from selfcorr_tpu_torch.models.meshnet import draw_step
from selfcorr_tpu_torch.train import loop
from selfcorr_tpu_torch.train.loop import (Trainer, make_train_dataset,
                                           step_generator)
from selfcorr_tpu_torch.train.optim import Optimizer
from selfcorr_tpu_torch.data.loader import compress_batch_host
from selfcorr_tpu_torch.train.step import train_step
from selfcorr_tpu_torch.utils import checkpoint as ckpt
from selfcorr_tpu_torch.utils import logging as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAPTOP = os.path.join(ROOT, "config/wild6d/laptop.txt")
TINY = ["--dataset_name", "synthetic", "--img_size", "32", "--corr_h", "8",
        "--corr_w", "8", "--noshape_prior", "--subdivide", "1",
        "--batch_size", "2",
        "--repeat", "2", "--pretrain_k", "8", "--n_corr_feat", "16",
        "--codedim", "8", "--symmetry_npts", "256", "--num_workers", "2",
        "--batch_log_interval", "1"]


def tiny_args(tmp, device="cpu"):
    return ["--flagfile", LAPTOP, *TINY, "--device", device,
            "--checkpoint_dir", str(tmp)]


def plan_batches(cfg, n):
    """The first n host batches of a fresh dataset's sample stream, packed
    as the loader packs them."""
    ds = make_train_dataset(cfg)
    return [compress_batch_host(stack_items(
        [ds.load_item(*a) for a in ds.sample_plan(i)])) for i in range(n)]


def take_step(trainer, batch, i):
    cfg = trainer.cfg
    draws = draw_step(step_generator(cfg.seed, i), cfg,
                      batch["img"].shape[0])
    return train_step(trainer.state, batch, draws, cfg)


def straight_and_resumed(cfg) -> dict:
    """Trainer "a" takes two steps; trainer "b0" takes the first and saves,
    and a fresh Trainer "b" over b0's run directory resumes and takes the
    second; on the same two uploaded batches and draws. Returns the three
    Trainers, the batches, each run's second-step metrics ("ma", "mb"), and
    the state b0 saved and b resumed ("saved", "resumed")."""
    a = Trainer(cfg.replace(name="a"))
    batches = [a.upload(h) for h in plan_batches(cfg, 2)]
    take_step(a, batches[0], 0)
    ma = take_step(a, batches[1], 1)
    b0 = Trainer(cfg.replace(name="b"))
    take_step(b0, batches[0], 0)
    b0.save(1)
    b = Trainer(cfg.replace(name="b"))
    out = dict(a=a, b0=b0, b=b, batches=batches, ma=ma,
               saved=state_tensors(b0), resumed=state_tensors(b))
    out["mb"] = take_step(b, batches[1], 1)
    return out


def state_tensors(trainer) -> dict:
    """A copy of every tensor of a train state, by name: the model's
    state_dict, the trunk's, each AdamW moment and step count; and
    TrainState.step."""
    st = trainer.state
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    out.update({f"dino.{k}": v for k, v in st.dino.state_dict().items()})
    for pid, s in st.optimizer.adamw.state_dict()["state"].items():
        out.update({f"adamw.{pid}.{k}": v for k, v in s.items()})
    out = {k: v.clone() for k, v in out.items()}
    out["step"] = torch.tensor(st.step)
    return out


def assert_equal_states(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    bad = [k for k in want if got[k].device != want[k].device
           or not torch.equal(got[k], want[k])]
    assert not bad, bad[:10]


def test_resume_is_bitwise(tmp_path):
    r = straight_and_resumed(parse_args(tiny_args(tmp_path)))
    assert_equal_states(r["resumed"], r["saved"])
    assert any(k.endswith(".exp_avg_sq") for k in r["saved"])
    assert r["b"].state.step == r["a"].state.step == 2
    assert_equal_states(state_tensors(r["b"]), state_tensors(r["a"]))
    ma, mb = r["ma"], r["mb"]
    assert sorted(mb) == sorted(ma)
    assert all(torch.equal(mb[k], ma[k]) for k in ma), (ma, mb)


def test_dino_bf16_resume_is_bitwise(tmp_path):
    """--dino_bf16: a checkpoint restores into the run's trunk dtype, so
    one written without the flag resumes a bf16 run with its trunk rounded
    to bfloat16 (as init_state rounds an imported trunk); the bf16 run's own
    checkpoint holds the trunk in bfloat16, and a Trainer that resumes from
    it holds the saved state bit for bit and steps as the saving one."""
    cfg = parse_args(tiny_args(tmp_path) + ["--dino_bf16"])
    a = Trainer(cfg)
    # a checkpoint whose trunk is float32, off the bf16 grid
    f32 = copy.copy(a.state)
    f32.dino = copy.deepcopy(a.state.dino).float()
    with torch.no_grad():
        for p in f32.dino.parameters():
            p.mul_(1.0 + 2.0 ** -12)
    ckpt.save_state(os.path.join(str(tmp_path), "f32"), f32, 0)
    ckpt.restore_state(os.path.join(str(tmp_path), "f32"), a.state)
    got = a.state.dino.state_dict()
    assert all(got[k].dtype == torch.bfloat16
               and torch.equal(got[k], v.to(torch.bfloat16))
               for k, v in f32.dino.state_dict().items())
    batches = [a.upload(h) for h in plan_batches(cfg, 2)]
    take_step(a, batches[0], 0)
    a.save(1)
    raw = ckpt.restore_raw(a.ckpt_dir)
    assert raw["dino"] and all(v.dtype == torch.bfloat16
                               for v in raw["dino"].values())
    b = Trainer(cfg)
    assert_equal_states(state_tensors(b), state_tensors(a))
    ma, mb = take_step(a, batches[1], 1), take_step(b, batches[1], 1)
    assert_equal_states(state_tensors(b), state_tensors(a))
    assert all(torch.equal(mb[k], ma[k]) for k in ma)


class Recorder:
    """A writer that keeps its add_scalar calls."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`main` with --total_iters 2 --save_freq 1, then a leftover temporary
    file of a step 3 in its ckpt directory, then `main` with --total_iters
    3 over the same run directory: each run's writer, output and uploaded
    host batches."""
    tmp = tmp_path_factory.mktemp("runs")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, iters in (("first", 2), ("second", 3)):
            writer, uploaded, text = Recorder(), [], io.StringIO()
            mp.setattr(loop, "make_writer", lambda d, w=writer: w)
            upload = Trainer.upload

            def keep(self, host, uploaded=uploaded, upload=upload):
                uploaded.append(host)
                return upload(self, host)
            mp.setattr(Trainer, "upload", keep)
            with contextlib.redirect_stdout(text):
                trainer = loop.main(["train", *tiny_args(tmp),
                                     "--total_iters", str(iters),
                                     "--save_freq", "1"])
            out[name] = dict(trainer=trainer, writer=writer,
                             uploaded=uploaded, text=text.getvalue())
            mp.setattr(Trainer, "upload", upload)
            if name == "first":
                out["steps_after_first"] = sorted(
                    os.listdir(trainer.ckpt_dir))
                partial = os.path.join(trainer.ckpt_dir, "3")
                os.makedirs(partial)
                open(os.path.join(partial, ckpt.FILE + ".tmp"), "wb").close()
                out["latest_with_partial"] = ckpt.latest_step(
                    trainer.ckpt_dir)
    out["cfg"] = out["second"]["trainer"].cfg
    return out


def test_trainer_saves_and_resumes(runs):
    first, second = runs["first"], runs["second"]
    assert runs["steps_after_first"] == ["1", "2"]
    assert "resuming" not in first["text"]
    assert "saved checkpoint at step 1" in first["text"]
    assert "saved checkpoint at step 2" in first["text"]
    # a temporary file left by a killed save is not a checkpoint
    assert runs["latest_with_partial"] == 2
    assert "resuming from checkpoint step 2" in second["text"]
    assert [s for s, _ in second["trainer"].logged] == [3]
    assert "iter 3/3" in second["text"] and "iter 2/" not in second["text"]
    assert second["trainer"].state.step == 3
    assert ckpt.latest_step(second["trainer"].ckpt_dir) == 3
    raw = ckpt.restore_raw(second["trainer"].ckpt_dir)
    assert raw["step"] == 3 and sorted(raw) == ["dino", "model",
                                                "optimizer", "step"]
    assert raw["optimizer"]["groups"] == second["trainer"].state \
        .optimizer.names


def test_resumed_loader_starts_the_sample_stream_afresh(runs):
    """The resumed run's one batch is a fresh dataset's first, not its
    third: the JAX loader's semantics (selfcorr_tpu/data/loader.py:180)."""
    import numpy as np
    fresh = plan_batches(runs["cfg"], 3)
    got = runs["second"]["uploaded"]
    assert len(got) == 1 and len(runs["first"]["uploaded"]) == 2
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], fresh[0][k], err_msg=k)
    assert not np.array_equal(got[0]["img"], fresh[2]["img"])


def test_scalar_log_matches_jax_tags_and_steps(runs):
    from selfcorr_tpu.utils.logging import TAGS
    assert L.TAGS == TAGS
    for name, steps in (("first", [0, 1]), ("second", [2])):
        run = runs[name]
        calls = run["writer"].scalars
        logged = run["trainer"].logged
        assert len(logged) == len(steps)
        want = [(TAGS.get(k, k), v, step)
                for step, (_, vals) in zip(steps, logged)
                for k, v in vals.items()]
        assert calls == want
    assert {t for t, _, _ in runs["first"]["writer"].scalars} >= {
        "total_loss/total_loss", "norms/bad_grad",
        "render_loss/mask_loss"}


def test_config_snapshot_matches_jax(runs, tmp_path):
    from selfcorr_tpu.configs import parse_args as jax_parse_args
    from selfcorr_tpu.utils.logging import write_config_snapshot
    tr = runs["second"]["trainer"]
    args = [a for a in tiny_args(tr.cfg.checkpoint_dir)
            if a not in ("--device", "cpu")] + ["--total_iters", "3",
                                                "--save_freq", "1"]
    write_config_snapshot(str(tmp_path), jax_parse_args(args))
    with open(os.path.join(tr.run_dir, "config.txt")) as f:
        port = f.read().splitlines()
    with open(os.path.join(tmp_path, "config.txt")) as f:
        jax_lines = f.read().splitlines()
    assert [ln for ln in port if ln != "--device=cpu"] == jax_lines
    assert len(port) == len(jax_lines) + 1


def test_make_writer_falls_back_without_tensorboard(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                   None)
        w = L.make_writer(str(tmp_path))
    assert isinstance(w, L.NoopWriter)
    L.log_metrics(w, {"total_loss": 1.0}, 0)


def test_tester_loads_the_model_of_a_checkpoint(runs):
    """--model_path: a run's ckpt directory gives its latest step, a step
    directory that step; the model and its BatchNorm buffers, bit for
    bit."""
    tr = runs["second"]["trainer"]
    for path, step in ((tr.ckpt_dir, 3),
                       (os.path.join(tr.ckpt_dir, "2"), 2)):
        tester = Tester(tr.cfg.replace(train=False, model_path=path,
                                       name="test"))
        want = ckpt.restore_raw(tr.ckpt_dir, step)["model"]
        got = tester.model.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), path
    assert os.path.isfile(os.path.join(tr.cfg.checkpoint_dir, "test",
                                       "config-test.txt"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_raw(tr.ckpt_dir, 5)


def test_optimizer_refuses_other_groups(runs):
    """A checkpoint's optimizer over other groups (here without the vert
    group: a shape prior that does not deform freezes mean_v) is refused,
    not loaded into the wrong parameters."""
    tr = runs["second"]["trainer"]
    raw = ckpt.restore_raw(tr.ckpt_dir)
    cfg = tr.cfg.replace(shape_prior=True, prior_deform=False)
    opt = Optimizer(copy.deepcopy(tr.state.model), cfg)
    assert opt.names == raw["optimizer"]["groups"][1:]
    with pytest.raises(ValueError, match="groups"):
        opt.load_state_dict(raw["optimizer"])
