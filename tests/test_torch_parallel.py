"""Data parallelism of the port (selfcorr_tpu_torch/parallel) on the CPU:
two gloo ranks, each in its own process, at the port tests' small size.

(a) The two-rank train step against the JAX package's
make_sharded_train_step on a 2-device mesh (Pallas in interpret mode), from
the JAX initialization: each rank takes its half of the global batch and
the draws of fold_in(rng, rank), as the JAX step's shard_map folds its key
with the axis index. Tolerances are test_torch_train_step.py's (losses 1e-4
relative; gradients, here after the clip, 2e-3 of the leaf's largest entry;
parameters 2e-7 / 1e-5; moments 2e-3 / 5e-3; BatchNorm statistics 1e-4).
(b) The same step against the composite of the two single-rank steps on the
shards (run in the same rank processes): the mean of their gradients, aux
losses and BatchNorm statistics, then the clip and AdamW. Within 1e-6 of
each tensor's largest entry (bit for bit is expected), and the ranks end
with equal parameters.
(c) The readers' plans: at num_shards=1 as before (digests of the plans the
readers drew before num_shards came back), at 2 the two one-shard plans in
a row; the loaders' row ranges partition the global batch.
The entry points at --num_devices 2 are test_torch_parallel_entry.py's.

The rank processes run under a subprocess with a timeout.
"""
import hashlib
import os
import subprocess
import sys

import numpy as np
import jax
import optax
import pytest
import torch

from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu.ops.rasterizer import pallas_raster as PR
from selfcorr_tpu.parallel import make_mesh, replicate, shard_batch
from selfcorr_tpu.train import optim as JO
from selfcorr_tpu.train.step import init_state as jax_init_state
from selfcorr_tpu.train.step import make_sharded_train_step
from selfcorr_tpu_torch import parallel as P
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.loader import TestLoader, TrainLoader
from selfcorr_tpu_torch.models.meshnet import MeshNet, build_mesh_constants
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.train import optim as O
from selfcorr_tpu_torch.train import step as S
from selfcorr_tpu_torch.train.step import init_state, train_step
from selfcorr_tpu_torch.utils import weight_convert as W
from test_torch_train_step import (TINY, jax_draws, merged_moments,
                                   np_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
RANKS = 2
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
    [ROOT, TESTS] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


# ---------------------------------------------------------------------------
# the rank processes of (a) and (b)
# ---------------------------------------------------------------------------

def fresh_state(inputs):
    cfg = Config(device="cpu", **TINY)
    pconst = build_mesh_constants(cfg)
    model = MeshNet(cfg, pconst)
    model.load_state_dict(inputs["model"])
    dino = DinoViTS8(img_size=cfg.img_size, attn_bf16=False)
    dino.load_state_dict(inputs["dino"])
    return cfg, init_state(cfg, pconst, "cpu", model=model, dino=dino)


def _step_rank(rank: P.Rank, path: str):
    """Rank `rank` of (a) / (b): one single-rank step on its shard (the
    gradients kept before the clip), then the two-rank step from the same
    state; both written to <path>.rank<r>."""
    inputs = torch.load(path, weights_only=False)
    lo, hi = P.process_row_range(rank.rank, rank.world,
                                 len(inputs["batch"]["img"]))
    shard = {k: torch.tensor(v[lo:hi]) for k, v in inputs["batch"].items()}
    draws = inputs["draws"][rank.rank]
    out = {}
    cfg, st = fresh_state(inputs)
    grads = {}
    guard = S.clip_and_guard

    def keep_then_clip(model):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return guard(model)
    S.clip_and_guard = keep_then_clip
    try:
        m = train_step(st, shard, draws, cfg)
    finally:
        S.clip_and_guard = guard
    out["single"] = dict(metrics={k: v.clone() for k, v in m.items()},
                         grads=grads, stats={n: b.clone() for n, b in
                                             st.model.named_buffers()})
    cfg, st = fresh_state(inputs)
    m = train_step(st, shard, draws, cfg, group=rank.group)
    out["dp"] = dict(metrics={k: v.clone() for k, v in m.items()},
                     grads={n: p.grad.clone()
                            for n, p in st.model.named_parameters()},
                     model=st.model.state_dict(),
                     optimizer=st.optimizer.state_dict())
    torch.save(out, f"{path}.rank{rank.rank}")


def run_step_ranks(path: str):
    P.run_ranks(_step_rank, P.Layout(RANKS, 0, ("cpu",) * RANKS), path)


def in_subprocess(code: str, timeout: int = 600):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


# ---------------------------------------------------------------------------
# (a), (b)
# ---------------------------------------------------------------------------

def capture_updates():
    """An optax transformation whose state is the last updates it saw (in
    a chain ahead of the optimizer: the clipped gradients)."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(np.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX sharded step on a 2-device mesh and the port's ranks, from
    one initialization, batch and key."""
    from selfcorr_tpu.configs import Config as JConfig
    jcfg = JConfig(use_pallas=True, **TINY)
    constants = JM.build_mesh_constants(jcfg)
    state = jax.jit(lambda k: jax_init_state(jcfg, constants, k))(
        jax.random.PRNGKey(0))
    tx = optax.chain(capture_updates(), JO.make_optimizer(jcfg, state.params))
    state = state._replace(opt_state=tx.init(state.params))
    rows = RANKS * jcfg.batch_size * jcfg.repeat
    batch = np_batch(seed=3, b=rows)
    rng = jax.random.PRNGKey(7)
    mesh = make_mesh(RANKS)
    step = make_sharded_train_step(jcfg, constants, tx, mesh, donate=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "COMPACT", True)
        new, metrics = step(replicate(mesh, state), shard_batch(mesh, batch),
                            rng)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    new, metrics = to_np(new), to_np(metrics)
    bs = to_np(state.batch_stats)
    clipped, opt = new.opt_state
    jx = dict(
        aux={k: v for k, v in metrics.items()
             if not k.startswith("grad_") and k != "bad_grad"},
        norms={k: v for k, v in metrics.items() if k.startswith("grad_")},
        grads=W.from_jax_params(clipped, bs),
        new_params=W.from_jax_params(new.params, new.batch_stats),
        mu=W.from_jax_params(merged_moments(opt, new.params, "mu"),
                             new.batch_stats),
        nu=W.from_jax_params(merged_moments(opt, new.params, "nu"),
                             new.batch_stats))

    # the one-device steps on the shards, each with its rank's key
    def shard_loss(params, shard, key):
        return JM.forward_train(params, state.batch_stats, state.dino_params,
                                shard, constants, key, jcfg, 0)
    grad_fn = jax.jit(jax.value_and_grad(shard_loss, has_aux=True))
    per = rows // RANKS
    jx["single"] = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "COMPACT", True)
        for r in range(RANKS):
            (_, (aux, _)), g = grad_fn(
                state.params, {k: v[r * per: (r + 1) * per]
                               for k, v in batch.items()},
                jax.random.fold_in(rng, r))
            jx["single"].append(dict(aux=to_np(aux), grads=W.from_jax_params(
                to_np(g), bs)))

    path = str(tmp_path_factory.mktemp("dp") / "inputs.pt")
    n_sym = TINY["symmetry_npts"]
    torch.save({"model": W.from_jax_params(to_np(state.params), bs),
                "dino": W.from_jax_dino_params(to_np(state.dino_params)),
                "batch": batch,
                "draws": [jax_draws(jax.random.fold_in(rng, r),
                                    rows // RANKS, n_sym)
                          for r in range(RANKS)]}, path)
    in_subprocess("import test_torch_parallel as T; "
                  f"T.run_step_ranks({path!r})")
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False)
             for r in range(RANKS)]
    return dict(jax=jx, ranks=ranks, inputs=torch.load(path,
                                                       weights_only=False))


def port_after(sh, rank: int):
    """A port state holding rank `rank`'s state after the two-rank step."""
    cfg, st = fresh_state(sh["inputs"])
    dp = sh["ranks"][rank]["dp"]
    st.model.load_state_dict(dp["model"])
    st.optimizer.load_state_dict(dp["optimizer"])
    st.step = 1
    return st


def single_device_gap(sh):
    """How far the port's one-device steps on the shards already are from
    the JAX package's (each rank's own single-rank step against JAX
    forward_train's value and gradient on that shard and key): per aux loss,
    and per leaf the largest gradient difference, the larger of the two
    shards'."""
    single = [r["single"] for r in sh["ranks"]]
    jsingle = sh["jax"]["single"]
    loss = {k: max(abs(float(p["metrics"][k]) - float(j["aux"][k]))
                   for p, j in zip(single, jsingle))
            for k in jsingle[0]["aux"]}
    grad = {n: max(float((p["grads"][n] - torch.as_tensor(j["grads"][n]))
                         .abs().max()) for p, j in zip(single, jsingle))
            for n in single[0]["grads"]}
    return loss, grad


def test_two_rank_step_matches_jax_sharded_step(sharded):
    """test_torch_train_step.py's tolerances, widened per loss and per leaf
    by what the one-device steps on the same shards already differ by
    (single_device_gap): on these shards the one-device gradients differ
    by up to 27x that file's bound (ROADMAP C.13: the render's coverage is
    a sigma = 1e-4 sigmoid of the edge distance, which turns the packages'
    rounding differences at edge pixels into gradient differences, and
    the symmetry loss's area-weighted face pick is a step function of the
    face areas). The two-rank step must add nothing to that: a sum for a
    mean, a missing BatchNorm average or the wrong draws would each exceed
    the bound."""
    jx, dp = sharded["jax"], sharded["ranks"][0]["dp"]
    gap_loss, gap_grad = single_device_gap(sharded)
    for k, v in jx["aux"].items():
        err = abs(float(dp["metrics"][k]) - float(v))
        assert err <= 1e-4 * abs(float(v)) + 1e-7 + gap_loss[k], (
            k, err, gap_loss[k])
    for k, v in jx["norms"].items():
        np.testing.assert_allclose(float(dp["metrics"][k]), float(v),
                                   rtol=2e-3, err_msg=k)
    st = port_after(sharded, 0)
    new = st.model.state_dict()
    mu = {n: st.optimizer.adamw.state[p]["exp_avg"]
          for n, p in st.model.named_parameters()
          if p in st.optimizer.adamw.state}
    nu = {n: st.optimizer.adamw.state[p]["exp_avg_sq"]
          for n, p in st.model.named_parameters()
          if p in st.optimizer.adamw.state}
    bad = []
    for n, g in dp["grads"].items():
        ref = jx["grads"][n].numpy()
        scale = float(np.abs(ref).max())
        gap = gap_grad[n]

        def within(what, got, want, lim):
            err = float(np.abs(np.asarray(got) - want).max())
            if not err <= lim:
                bad.append((what, n, err, lim))
        within("grad", g, ref, max(2e-3 * scale, 1e-7) + gap)
        if n in mu:     # AdamW's first step: 0.1 g and 0.001 g^2
            m, v = jx["mu"][n].numpy(), jx["nu"][n].numpy()
            within("mu", mu[n], m, 2e-3 * np.abs(m).max() + 0.1 * gap)
            within("nu", nu[n], v, 5e-3 * np.abs(v).max()
                   + 2e-3 * scale * gap + 1e-3 * gap ** 2)
            # parameters: 2e-7 where the gradient's sign is settled
            settled = np.abs(ref) > max(1e-3 * scale, 1e-6, gap)
            lim = np.where(settled, 2e-7, 1e-5)
            err = np.abs(new[n].numpy() - jx["new_params"][n].numpy())
            if not (err <= lim).all():
                bad.append(("param", n, float(err.max()), None))
    assert not bad, bad
    stats = [n for n in new if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 26
    for n in stats:
        np.testing.assert_allclose(new[n].numpy(),
                                   jx["new_params"][n].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_two_rank_step_is_the_mean_of_single_rank_steps(sharded):
    """The composite: mean gradients, aux losses and BatchNorm statistics
    of the single-rank steps, then the clip and one AdamW step, from the
    initial state."""
    single = [r["single"] for r in sharded["ranks"]]
    cfg, st = fresh_state(sharded["inputs"])
    model = st.model
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith(("running_mean", "running_var")):
                b.copy_((single[0]["stats"][n] + single[1]["stats"][n])
                        / RANKS)
            else:
                b.copy_(single[0]["stats"][n])
    for n, p in model.named_parameters():
        p.grad = (single[0]["grads"][n] + single[1]["grads"][n]) / RANKS
    norms, bad = O.clip_and_guard(model)
    st.optimizer.step(0)
    dp = [r["dp"] for r in sharded["ranks"]]

    def close(got, want, what):
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max()) / scale
        assert err <= 1e-6, (what, err)

    for n, v in model.state_dict().items():
        close(dp[0]["model"][n].double(), v.double(), n)
    for k in single[0]["metrics"]:
        if k.startswith("grad_"):
            close(dp[0]["metrics"][k], norms[k], k)
        elif k != "bad_grad":
            close(dp[0]["metrics"][k], (single[0]["metrics"][k]
                                        + single[1]["metrics"][k]) / RANKS, k)
    assert float(bad) == 0.0 == float(dp[0]["metrics"]["bad_grad"])
    opt = st.optimizer.state_dict()
    for pid, s in opt["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            close(dp[0]["optimizer"]["adamw"]["state"][pid][k], s[k],
                  (pid, k))
    # the ranks end alike
    for n, v in dp[0]["model"].items():
        assert torch.equal(dp[1]["model"][n], v), n
    for k, v in dp[0]["metrics"].items():
        assert torch.equal(dp[1]["metrics"][k], v), k


# ---------------------------------------------------------------------------
# (c) plans and row ranges
# ---------------------------------------------------------------------------

# sha256 of each reader's first three plans at seed 0 (synthetic: the
# defaults; the others: the fixture trees of plan_reader), as the readers
# drew them before they took num_shards
PLAN_DIGESTS = {
    "synthetic": "926008dbc1c202d29f90e858caba4992435c774b5ffefa40ae2058e89c6bd82e",
    "wild6d": "3bc6d966806f997f4f80fd197761769107880b3f0680610071e4fadde759bfda",
    "nocs": "022e704a75148b767d08c0ff1b1a4754e271136bf4ec38851aa1ee007344afac",
    "cub": "14213eec055ac1988edac7038cdce6c925f3fe80aae272f799d9a544e5a238b4",
}


def plan_digest(reader, steps=3) -> str:
    h = hashlib.sha256()
    for step in range(steps):
        for vid, fid, draws in reader.sample_plan(step):
            h.update(np.asarray([vid, fid], np.int64).tobytes())
            h.update(np.asarray(draws, np.float64).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Config fields of the Wild6D, NOCS and CUB fixture trees (small)."""
    from selfcorr_tpu_torch.data import fixtures as FX
    root = str(tmp_path_factory.mktemp("trees"))
    w6d = os.path.join(root, "wild6d")
    train_root, _ = FX.wild6d_tree(w6d, n_train_videos=3, n_test_videos=0,
                                   frames_per_video=7, raw_size=32)
    FX.write_list(train_root, w6d + ".txt")
    nocs = os.path.join(root, "nocs")
    cub = os.path.join(root, "cub")
    return {"synthetic": {},
            "wild6d": dict(dataset_path=train_root, train_list=w6d + ".txt"),
            "nocs": dict(dataset_path=nocs, train_list=FX.nocs_tree(nocs)),
            "cub": dict(dataset_path=cub, train_list=FX.cub_tree(
                cub, per_class=3, split="train"))}


def plan_reader(name: str, fields: dict, num_shards: int | None = None):
    """The training reader `name` at seed 0 over `fields` (trees); without
    num_shards the reader's default."""
    from selfcorr_tpu_torch.data.cub import CUBTrain
    from selfcorr_tpu_torch.data.nocs import NOCSTrain
    from selfcorr_tpu_torch.data.synthetic import SyntheticTrain
    from selfcorr_tpu_torch.data.wild6d import Wild6DTrain
    cls = {"synthetic": SyntheticTrain, "wild6d": Wild6DTrain,
           "nocs": NOCSTrain, "cub": CUBTrain}[name]
    cfg = Config(batch_size=2, repeat=3, img_size=32, **fields)
    kw = {} if num_shards is None else {"num_shards": num_shards}
    return cls(cfg, seed=0, **kw)


READERS = ("synthetic", "wild6d", "nocs", "cub")


@pytest.mark.parametrize("name", READERS)
def test_one_shard_plan_is_unchanged(name, trees):
    for shards in (None, 1):
        assert plan_digest(plan_reader(name, trees[name], shards)) == \
            PLAN_DIGESTS[name], shards


def same_plan(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:2] == y[:2]
        np.testing.assert_array_equal(x[2], y[2])


@pytest.mark.parametrize("name", READERS)
def test_two_shard_plan_is_two_one_shard_plans(name, trees):
    """Shard-major: the two blocks of a two-shard plan are the plans of
    two one-shard steps in a row, and the ranks' row ranges cut it into
    those blocks."""
    one = plan_reader(name, trees[name])
    two = plan_reader(name, trees[name], 2)
    rows = 2 * 3
    for step in range(2):
        plan = two.sample_plan(step)
        blocks = [one.sample_plan(2 * step), one.sample_plan(2 * step + 1)]
        ranges = [P.process_row_range(r, RANKS, len(plan))
                  for r in range(RANKS)]
        assert ranges == [(0, rows), (rows, 2 * rows)]
        for (lo, hi), block in zip(ranges, blocks):
            same_plan(plan[lo:hi], block)


def test_row_range_splits_evenly():
    assert [P.process_row_range(r, 4, 32) for r in range(4)] == [
        (0, 8), (8, 16), (16, 24), (24, 32)]
    with pytest.raises(ValueError, match="do not split"):
        P.process_row_range(0, 3, 32)


@pytest.mark.parametrize("processes", [False, True])
def test_train_loader_rows_are_the_global_batch(processes):
    """Each rank's TrainLoader (threads, or worker processes) loads its
    rows of the global plan: the ranks' batches, stacked, are the one-rank
    loader's over the same two-shard reader."""
    from selfcorr_tpu_torch.data.synthetic import SyntheticTrain
    cfg = Config(batch_size=2, repeat=2, img_size=32, total_iters=2,
                 num_workers=1, loader_processes=processes)

    def batches(row_range):
        loader = TrainLoader(SyntheticTrain(cfg, num_shards=RANKS), cfg,
                             row_range=row_range)
        try:
            return list(loader)
        finally:
            loader.close()
    rows = RANKS * cfg.batch_size * cfg.repeat
    whole = batches(None)
    parts = [batches(P.process_row_range(r, RANKS, rows))
             for r in range(RANKS)]
    assert len(whole) == 2
    for step, full in enumerate(whole):
        assert len(full["img"]) == rows
        for k, v in full.items():
            np.testing.assert_array_equal(
                np.concatenate([p[step][k] for p in parts]), v, err_msg=k)


def test_test_loader_rows_are_the_global_batch():
    """The ranks' TestLoader rows, with their slices of `valid`, stacked,
    are the one-rank loader's, padded tail batch included."""
    from selfcorr_tpu_torch.data.synthetic import SyntheticTest
    cfg = Config(batch_size=8, img_size=32, dframe_eval=1, eval=True,
                 num_workers=2)
    ds = SyntheticTest(cfg)
    assert len(ds) % cfg.batch_size        # a padded tail batch
    whole = list(TestLoader(ds, cfg))
    parts = [list(TestLoader(ds, cfg, P.process_row_range(
        r, RANKS, cfg.batch_size))) for r in range(RANKS)]
    assert not parts[1][-1]["valid"].any()  # rank 1's tail rows: padding
    for i, full in enumerate(whole):
        for k, v in full.items():
            np.testing.assert_array_equal(
                np.concatenate([p[i][k] for p in parts]), v, err_msg=k)
