"""One training step of the port against the JAX package's train_step.

Both start from the JAX initialization (weights carried by from_jax_params /
from_jax_dino_params), take the same batch and the same draws (the JAX
step's color-jitter factors, symmetry samples and rotation angle, injected
into the port), and update once. The JAX step runs its Pallas rasterizer in
interpret mode (use_pallas=True, the kernels' custom VJP, which B2 ports) and
the f32 DINO trunk (dino_attn_bf16=False); the port runs its plain versions
on the CPU. One JAX compile is shared by the module.

The JAX dense backend (use_pallas=False) is not the oracle here: its
autodiff gradients are not the kernels' VJP semantics, and at this size they
differ from the Pallas step's by up to 8% of a leaf's scale (the rotation
head, whose gradient comes only through the render); the losses agree.
tests/test_torch_raster_bwd.py holds the port's render gradients against
both backends at the JAX package's own tolerances.

Tolerances, from the measured differences (largest seen in brackets): aux
losses 1e-4 relative; per-leaf gradients 2e-3 of the leaf's largest entry,
and at least 1e-7 (the mean-centred shape delta's bias has an analytically
zero gradient, ~1e-8 of noise) (5.7e-4); updated parameters 2e-7 absolute
where the gradient is above 1e-3 of its leaf's scale and 1e-6, else 1e-5:
AdamW's first step moves every entry by about the learning rate (4e-6
here), and an entry whose gradient is rounding noise may move either way;
Adam moments 2e-3 (first) and 5e-3 (second) of the leaf's largest entry;
BatchNorm statistics 1e-4.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from selfcorr_tpu.configs import Config as JConfig
from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu.train import optim as JO
from selfcorr_tpu.train.step import init_state as jax_init_state
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.models.meshnet import (MeshNet, StepDraws,
                                               build_mesh_constants,
                                               forward_train)
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.train import optim as O
from selfcorr_tpu_torch.train import step as S
from selfcorr_tpu_torch.train.step import init_state, train_step
from selfcorr_tpu_torch.utils import weight_convert as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, corr_h=8, corr_w=8, subdivide=1, batch_size=2,
            repeat=2, total_iters=10, symmetry_idx=0, symmetry_npts=256,
            use_depth=True, divide_fn="both", pretrain_k=8, n_corr_feat=16,
            codedim=8, depth_offset=5.0, dino_attn_bf16=False)


def np_batch(seed=0, b=4, s=32):
    rng = np.random.RandomState(seed)
    mask = np.zeros((b, s, s), np.float32)
    mask[:, s // 4: 3 * s // 4, s // 4: 3 * s // 4] = 1.0
    return {"img": rng.rand(b, s, s, 3).astype(np.float32), "mask": mask,
            "depth": (mask * (5.0 + rng.rand(b, s, s))).astype(np.float32),
            "occ": np.zeros((b, s, s), np.float32),
            "pp_crop": np.zeros((b, 2), np.float32),
            "foc_crop": np.full((b, 2), 2.0, np.float32)}


def jax_draws(rng, b, n_sym):
    """The draws forward_train makes from `rng` (meshnet.py:211), as torch
    tensors."""
    k_jit, k_sym, k_cyc, k_cycjit = jax.random.split(rng, 4)

    def jitter(key):
        kb, kc, ks, kh = jax.random.split(key, 4)
        return torch.tensor([
            float(jax.random.uniform(kb, (), minval=0.8, maxval=1.2)),
            float(jax.random.uniform(kc, (), minval=0.8, maxval=1.2)),
            float(jax.random.uniform(ks, (), minval=0.8, maxval=1.2)),
            float(jax.random.uniform(kh, (), minval=-0.05, maxval=0.05))])

    kf, kb = jax.random.split(k_sym)
    u = jax.random.uniform(kf, (b, n_sym, 1))
    ub = jax.random.uniform(kb, (b, n_sym, 2))
    angle = jax.random.uniform(k_cyc, (), minval=0.0, maxval=360.0)
    return StepDraws(jitter=jitter(k_jit), sym_u=torch.tensor(np.asarray(u)),
                     sym_ub=torch.tensor(np.asarray(ub)),
                     angle=torch.tensor(float(angle)),
                     cycle_jitter=jitter(k_cycjit))


def merged_moments(opt_state, params, field):
    """Adam's `field` ('mu' / 'nu') of every leaf, from whichever group's
    masked state holds it (zeros for frozen leaves)."""
    flat = {}
    for group, st in opt_state.inner_states.items():
        if group == "frozen":
            continue
        adam = st.inner_state[0]
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(adam, field))[0]:
            flat[jax.tree_util.keystr(path)] = leaf
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(flat.get(jax.tree_util.keystr(p),
                                         np.zeros_like(x))), params)


@pytest.fixture(scope="module")
def shared():
    jcfg = JConfig(use_pallas=True, **TINY)
    constants = JM.build_mesh_constants(jcfg)
    state = jax.jit(lambda k: jax_init_state(jcfg, constants, k))(
        jax.random.PRNGKey(0))
    tx = JO.make_optimizer(jcfg, state.params)
    batch = np_batch()
    rng = jax.random.PRNGKey(1)

    def step(params, opt_state):
        def loss_fn(p):
            return JM.forward_train(p, state.batch_stats, state.dino_params,
                                    {k: jnp.asarray(v) for k, v in
                                     batch.items()}, constants, rng, jcfg, 0)
        (_, (aux, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        clipped, norms, bad = JO.clip_and_guard(grads)
        updates, new_opt = tx.update(clipped, opt_state, params)
        return (aux, new_bs, grads, norms, bad,
                optax.apply_updates(params, updates), new_opt)

    out = jax.jit(step)(state.params, state.opt_state)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    aux, new_bs, grads, norms, bad, new_params, new_opt = to_np(out)

    cfg = Config(device="cpu", **TINY)
    pconst = build_mesh_constants(cfg)
    model = MeshNet(cfg, pconst)
    model.load_state_dict(W.from_jax_params(to_np(state.params),
                                            to_np(state.batch_stats)))
    dino = DinoViTS8(img_size=32, attn_bf16=False)
    dino.load_state_dict(W.from_jax_dino_params(to_np(state.dino_params)))
    return dict(
        cfg=cfg, pconst=pconst, model=model, dino=dino, batch=batch,
        draws=jax_draws(rng, 4, cfg.symmetry_npts), aux=aux, norms=norms,
        bad=bad, stats=to_np(state.batch_stats),
        grads=W.from_jax_params(grads, to_np(state.batch_stats)),
        new_params=W.from_jax_params(new_params, new_bs),
        mu=W.from_jax_params(merged_moments(new_opt, state.params, "mu"),
                             new_bs),
        nu=W.from_jax_params(merged_moments(new_opt, state.params, "nu"),
                             new_bs))


def port_state(sh):
    return init_state(sh["cfg"], sh["pconst"], "cpu",
                      model=copy.deepcopy(sh["model"]),
                      dino=copy.deepcopy(sh["dino"]))


def torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def close_per_leaf(got: dict, ref: dict, rtol: float, names):
    bad = []
    for n in names:
        g, r = got[n].numpy(), ref[n].numpy()
        lim = max(rtol * float(np.abs(r).max()), 1e-7)
        if not float(np.abs(g - r).max()) <= lim:
            bad.append((n, float(np.abs(g - r).max()), lim))
    assert not bad, bad


@pytest.fixture(scope="module")
def port_step(shared, monkeypatch_module):
    """One port train_step from the shared state; the gradients are kept as
    they were before clipping."""
    st = port_state(shared)
    grads = {}

    def keep_then_clip(model):
        grads.update({n: p.grad.clone()
                      for n, p in model.named_parameters()})
        return O.clip_and_guard(model)
    monkeypatch_module.setattr(S, "clip_and_guard", keep_then_clip)
    metrics = train_step(st, torch_batch(shared["batch"]), shared["draws"],
                         shared["cfg"])
    monkeypatch_module.undo()
    return st, metrics, grads


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_losses_and_gradients_match_jax(shared, port_step):
    sh = shared
    _, metrics, grads = port_step
    for k, v in sh["aux"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert set(grads) <= set(sh["grads"])
    close_per_leaf(grads, sh["grads"], 2e-3, sorted(grads))


def test_update_matches_jax(shared, port_step):
    """Parameters, Adam moments and BatchNorm statistics after one step,
    and the step's group norms."""
    sh = shared
    st, metrics, _ = port_step
    assert st.step == 1 and float(metrics["bad_grad"]) == 0.0
    for k, v in sh["norms"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=2e-3,
                                   err_msg=k)
    new = st.model.state_dict()
    params = [n for n, _ in st.model.named_parameters()]
    for n in params:
        got, ref = new[n].numpy(), sh["new_params"][n].numpy()
        g = np.abs(sh["grads"][n].numpy())
        lim = np.where(g > max(1e-3 * g.max(), 1e-6), 2e-7, 1e-5)
        assert (np.abs(got - ref) <= lim).all(), (n, np.abs(got - ref).max())
    trained = {id(p): n for g in st.optimizer.groups.values() for n, p in g}
    mu = {n: st.optimizer.adamw.state[p]["exp_avg"]
          for n, p in st.model.named_parameters() if id(p) in trained}
    nu = {n: st.optimizer.adamw.state[p]["exp_avg_sq"]
          for n, p in st.model.named_parameters() if id(p) in trained}
    close_per_leaf(mu, sh["mu"], 2e-3, sorted(mu))
    close_per_leaf(nu, sh["nu"], 5e-3, sorted(nu))
    stats = [n for n in new if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 26     # ResNet18: 20 BatchNorms, FPN: 6
    for n in stats:
        np.testing.assert_allclose(new[n].numpy(), sh["new_params"][n].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)


def test_frozen_parameters_are_in_no_group(shared):
    st = port_state(shared)
    grouped = {n for g in st.optimizer.groups.values() for n, _ in g}
    bn = {n for n, _ in st.model.named_parameters()
          if ".bn" in n or "cbr_unit.1" in n or "downsample.1" in n}
    assert bn and not bn & grouped
    assert grouped | bn == {n for n, _ in st.model.named_parameters()}
    assert [n for n, _ in st.optimizer.groups["vert"]] == ["mesh.mean_v"]
    prior = shared["cfg"].replace(shape_prior=True, prior_deform=False)
    assert O.param_groups(st.model, prior)["vert"] == []


def test_nan_guard_zeroes_gradients_and_still_updates(shared):
    """An injected inf: every gradient is zeroed, yet AdamW decays the
    moments, applies weight decay and advances its count, as the JAX step
    does."""
    sh = shared
    st = port_state(sh)
    batch = torch_batch(sh["batch"])
    train_step(st, batch, sh["draws"], sh["cfg"])
    p = st.model.encoder.pose_predictor.trans_pred_layer.weight
    before = p.detach().clone()
    m_before = st.optimizer.adamw.state[p]["exp_avg"].clone()
    hook = p.register_hook(lambda g: g * float("inf"))
    metrics = train_step(st, batch, sh["draws"], sh["cfg"])
    hook.remove()
    assert float(metrics["bad_grad"]) == 1.0
    assert all(float(q.grad.abs().max()) == 0.0
               for q in st.model.parameters())
    torch.testing.assert_close(st.optimizer.adamw.state[p]["exp_avg"],
                               0.9 * m_before, rtol=1e-6, atol=0)
    assert float(st.optimizer.adamw.state[p]["step"]) == 2.0 and st.step == 2
    assert not torch.equal(p.detach(), before)   # decay + momentum moved it


@pytest.mark.parametrize("total", [1, 2, 10, 200, 20000])
def test_schedule_matches_optax(total):
    sched = JO.onecycle(3e-4, total)
    for count in sorted({0, 1, 2, 3, total // 20, total // 2, total - 1,
                         total, total + 5}):
        ref = float(sched(count))
        if np.isfinite(ref):
            np.testing.assert_allclose(O.onecycle_lr(3e-4, total, count), ref,
                                       rtol=1e-5, err_msg=(total, count))


def test_static_zero_weight_skip(shared):
    """Zero-weighted terms are not computed (their inputs are not even
    touched) and log as exact zeros."""
    sh = shared
    cfg = sh["cfg"].replace(symmetry_wt=0.0, cycle_loss_wt=0.0,
                            cycle_loss_pretrain_wt=0.0, tex_wt=0.0,
                            match_wt=0.0, imatch_wt=0.0)
    st = port_state(sh)
    draws = sh["draws"]._replace(sym_u=None, sym_ub=None, angle=None,
                                 cycle_jitter=None)
    st.dino = None                     # the trunk must not run
    total, aux = forward_train(st.model, st.dino, torch_batch(sh["batch"]),
                               st.constants, cfg, 0, draws)
    assert torch.isfinite(total)
    for k in ("symmetry_loss", "cycle_loss", "cycle_loss_pretrain",
              "texture_loss", "match_loss", "imatch_loss"):
        assert float(aux[k]) == 0.0, k


def test_train_entry_point_on_cpu(tmp_path):
    """python -m selfcorr_tpu_torch.train end to end on the CPU: every
    logged loss is finite."""
    cmd = [sys.executable, "-m", "selfcorr_tpu_torch.train", "--flagfile",
           "config/wild6d/laptop.txt", "--dataset_name", "synthetic",
           "--total_iters", "2", "--batch_log_interval", "1",
           "--img_size", "32", "--corr_h", "8", "--corr_w", "8",
           "--batch_size", "2", "--repeat", "2", "--pretrain_k", "8",
           "--n_corr_feat", "16", "--codedim", "8", "--symmetry_npts", "256",
           "--num_workers", "2", "--device", "cpu",
           "--checkpoint_dir", str(tmp_path)]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("iter ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out.stdout
