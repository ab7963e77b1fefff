"""The port's device batch generator (data/synthetic_device.py,
--synthetic_on_device) against the JAX package's, and the Trainer's K-step
chunks (--steps_per_dispatch), on the CPU.

* Given the same draws (videos, frame offsets, crop scales), the crop boxes
  are equal as integers, for both synthetic shapes, and so are the masks,
  foc_crop and pp_crop. img and depth are float32 roundings of the same
  arithmetic: off the silhouette within 2e-4 and 0.3 mm of ~6000 (1.05e-4
  and 0.146 mm measured over four sets of draws); on it (a pixel with the
  other mask value in its 3 x 3 neighbourhood), where rays graze and the
  hit distance (-b - sqrt(disc)) / 2a turns a last-bit difference of disc
  into a larger one of t, within 5e-3 and 2 mm (7.9e-4 and 0.83 mm
  measured). A box that differed would shift every pixel of its item, and
  the image tolerance is not there to absorb it (ROADMAP C.15).
* The gen contract, as tests/test_synth_device.py pins the JAX one: shapes,
  dtypes, fresh draws per step, metric depth (the Trainer's runs below
  train on it).
* The Trainer on device batches with --steps_per_dispatch 3 equals 1 bit
  for bit (model, optimizer, logged losses), its chunks clipped at the log
  interval of 2; the device path is taken only where the JAX package takes
  it.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfcorr_tpu.data import synthetic_device as JSD
from selfcorr_tpu.data.synthetic import SyntheticVideos as JVideos
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data import synthetic_device as SD
from selfcorr_tpu_torch.data.synthetic import SyntheticVideos
from selfcorr_tpu_torch.train.loop import Trainer
from test_torch_threads import share_cores  # noqa: F401 (autouse)

TINY = dict(dataset_name="synthetic", img_size=32, corr_h=8, corr_w=8,
            subdivide=1, batch_size=2, repeat=2, pretrain_k=8, codedim=8,
            n_corr_feat=16, symmetry_npts=256, use_depth=True,
            depth_offset=5.0, synthetic_on_device=True, device="cpu")


def draws(seed, bs, rp, nv=4, nf=24):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nv, bs), rng.randint(0, max(nf // rp, 1),
                                                (bs, rp)),
            rng.uniform(1.2, 1.5, (bs * rp, 2)).astype(np.float32))


def silhouette(mask):
    """Pixels of a (B, H, W) bool mask with a pixel of the other value in
    their 3 x 3 neighbourhood."""
    m = np.pad(mask, ((0, 0), (1, 1), (1, 1)), mode="edge")
    h, w = mask.shape[1:]
    win = np.stack([m[:, i:i + h, j:j + w] for i in range(3)
                    for j in range(3)])
    return win.min(0) != win.max(0)


def jax_batch(videos, vids, offs, scale, s, rp):
    """make_device_synth's gen body with the draws given."""
    tables = JSD._video_tables(videos)
    n_parts = 1 if videos.shape == "ellipsoid" else 2
    nf = videos.n_frames
    gap = max(nf // rp, 1)
    fids = jnp.minimum(jnp.arange(rp)[None, :] * gap + jnp.asarray(offs),
                       nf - 1).reshape(-1)
    vids = jnp.repeat(jnp.asarray(vids), rp)
    theta = tables["phase"][vids] + 2.0 * jnp.pi * fids.astype(
        jnp.float32) / nf
    rmats = JSD._rot_mats(tables["tilt"][vids], theta)
    center, length0 = JSD.crop_bbox_analytic(
        tables, vids, rmats, tables["z0"][vids], videos.raw, n_parts)
    length = jnp.maximum((jnp.asarray(scale) * length0.astype(
        jnp.float32)).astype(jnp.int32), 1)
    out = JSD.render_crop(tables, vids, fids, center, length, s, videos.raw,
                          nf, n_parts)
    return ({k: np.asarray(v) for k, v in out.items()},
            np.asarray(center), np.asarray(length0), np.asarray(length))


@pytest.mark.parametrize("shape", ["ellipsoid", "duo"])
def test_batches_match_jax_given_the_draws(shape):
    bs, rp, s = 8, 4, 32
    vids, offs, scale = draws(1, bs, rp)
    want, center, length0, length = jax_batch(
        JVideos(seed=0, shape=shape), vids, offs, scale, s, rp)
    videos = SyntheticVideos(seed=0, shape=shape)
    tables = SD.video_tables(videos, "cpu")
    n_parts = 1 if shape == "ellipsoid" else 2
    fids = torch.clamp(torch.arange(rp)[None] * (24 // rp)
                       + torch.tensor(offs), max=23).reshape(-1)
    v = torch.repeat_interleave(torch.tensor(vids), rp)
    rot = SD.rot_mats(tables["tilt"][v], tables["phase"][v]
                      + 2.0 * np.pi * fids.float() / 24)
    c, l0 = SD.crop_bbox_analytic(tables, v, rot, tables["z0"][v], 320,
                                  n_parts)
    assert c.dtype == l0.dtype == torch.int32
    assert np.array_equal(c.numpy(), center)
    assert np.array_equal(l0.numpy(), length0)
    gen = SD.make_device_synth(Config(**{**TINY, "batch_size": bs,
                                         "repeat": rp}), videos, "cpu")
    got = gen(vids=vids, offs=offs, scale=scale)
    assert sorted(got) == ["depth", "foc_crop", "img", "mask", "occ",
                           "pp_crop"]
    for k in ("mask", "foc_crop", "pp_crop"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    edge = silhouette(want["mask"] > 0)
    # the render from the crop boxes as given
    out = SD.render_crop(tables, v, fids, torch.tensor(center),
                         torch.tensor(length), s, 320, 24, n_parts)
    for batch in (got, out):
        img = np.abs(batch["img"].numpy() - want["img"]).max(-1)
        depth = np.abs(batch["depth"].numpy() - want["depth"])
        assert img[~edge].max() <= 2e-4 and depth[~edge].max() <= 0.3
        assert img[edge].max() <= 5e-3 and depth[edge].max() <= 2.0


def test_gen_contract():
    cfg = Config(**{**TINY, "synthetic_shape": "duo"})
    videos = SyntheticVideos(seed=cfg.seed, shape="duo")
    gen = SD.make_device_synth(cfg, videos, "cpu")
    b1 = gen(SD.step_generator(cfg.seed, 0))
    b2 = gen(SD.step_generator(cfg.seed, 1))
    again = gen(SD.step_generator(cfg.seed, 0))
    b = cfg.batch_size * cfg.repeat
    assert b1["img"].shape == (b, 32, 32, 3) and b1["mask"].shape == (b, 32,
                                                                       32)
    assert all(v.dtype == torch.float32 for v in b1.values())
    assert all(torch.equal(b1[k], again[k]) for k in b1)
    assert float((b2["img"] - b1["img"]).abs().max()) > 0
    assert 0.0 < float(b1["mask"].mean()) < 1.0
    assert float(b1["depth"][b1["mask"] > 0].min()) > 1000.0  # mm, z 4-6 m


def test_steps_per_dispatch_equals_one_bit_for_bit(tmp_path, capsys,
                                                  monkeypatch):
    """One Trainer, 4 steps on device batches at --steps_per_dispatch 1,
    then from the same initial state at 3; the cycle losses off (the loop is
    under test, not the terms), no checkpoint written."""
    from selfcorr_tpu_torch.train import loop
    from selfcorr_tpu_torch.utils.logging import NoopWriter
    # the scalar writer would import TensorFlow here (~15 s)
    monkeypatch.setattr(loop, "make_writer", lambda run_dir: NoopWriter())
    monkeypatch.setattr(Trainer, "save", lambda self, step: None)
    cfg = Config(**{**TINY, "total_iters": 4, "batch_log_interval": 2,
                    "checkpoint_dir": str(tmp_path), "cycle_loss_wt": 0.0,
                    "cycle_loss_pretrain_wt": 0.0})
    trainer = Trainer(cfg)
    initial = copy.deepcopy(trainer.state)
    runs = []
    for k in (1, 3):
        trainer.cfg = cfg.replace(steps_per_dispatch=k)
        trainer.state = copy.deepcopy(initial)
        trainer.chunks, trainer.logged = [], []
        trainer.train()
        runs.append((trainer.chunks, trainer.logged, trainer.state))
    assert "made on the device" in capsys.readouterr().out
    (c1, log1, one), (c3, log3, three) = runs
    assert c1 == [1] * 4 and c3 == [2, 2]
    assert [s for s, _ in log1] == [s for s, _ in log3] == [2, 4]
    assert log1 == log3
    a, b = one.model.state_dict(), three.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    oa, ob = (st.optimizer.state_dict()["adamw"]["state"]
              for st in (one, three))
    assert all(torch.equal(oa[i][n], ob[i][n]) for i in oa for n in oa[i])
    assert one.step == three.step == 4


def test_device_path_only_where_jax_takes_it():
    """Not for another dataset, nor for several ranks; K is then ignored.
    (The rule reads only the config and the world size.)"""
    def trainer(world=1, **flags):
        t = Trainer.__new__(Trainer)
        t.cfg, t.world = Config(**{**TINY, "steps_per_dispatch": 3,
                                   **flags}), world
        return t
    host = trainer(dataset_name="Wild6D")
    assert not host.device_batches() and host.chunk(0) == 1
    dev = trainer()
    assert dev.device_batches() and dev.chunk(0) == 3
    assert dev.chunk(8) == 2      # clipped at the log step 10
    assert trainer(profile_steps=2).chunk(0) == 1
    assert not trainer(world=2).device_batches()
