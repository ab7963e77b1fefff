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
from selfcorr_tpu.ops.rasterizer import pallas_raster as PR
from selfcorr_tpu.train.step import init_state as jax_init_state
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.models.meshnet import (MeshNet, StepDraws,
                                               build_mesh_constants,
                                               forward_train, preprocess)
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.ops.rasterizer import api as raster_api
from selfcorr_tpu_torch.train import optim as O
from selfcorr_tpu_torch.train import step as S
from selfcorr_tpu_torch.train.step import init_state, train_step
from selfcorr_tpu_torch.utils import weight_convert as W
from test_torch_threads import thread_env

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


def build_shared(compact=True, **overrides):
    """The JAX step (rasterizer schedule `compact`: the Pallas module
    default patched while the step is traced) from the JAX initialization,
    and the port's model and DINO trunk carrying the same weights.
    `overrides` change TINY in both packages' configs."""
    jcfg = JConfig(use_pallas=True, **{**TINY, **overrides})
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

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "COMPACT", compact)
        out = jax.jit(step)(state.params, state.opt_state)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    aux, new_bs, grads, norms, bad, new_params, new_opt = to_np(out)

    cfg = Config(device="cpu", **{**TINY, **overrides})
    pconst = build_mesh_constants(cfg)
    model = MeshNet(cfg, pconst)
    model.load_state_dict(W.from_jax_params(to_np(state.params),
                                            to_np(state.batch_stats)))
    dino = DinoViTS8(img_size=32, attn_bf16=False)
    dino.load_state_dict(W.from_jax_dino_params(to_np(state.dino_params)))
    return dict(
        compact=compact, cfg=cfg, pconst=pconst, model=model, dino=dino,
        batch=batch,
        draws=jax_draws(rng, 4, cfg.symmetry_npts), aux=aux, norms=norms,
        bad=bad, stats=to_np(state.batch_stats),
        grads=W.from_jax_params(grads, to_np(state.batch_stats)),
        new_params=W.from_jax_params(new_params, new_bs),
        mu=W.from_jax_params(merged_moments(new_opt, state.params, "mu"),
                             new_bs),
        nu=W.from_jax_params(merged_moments(new_opt, state.params, "nu"),
                             new_bs))


@pytest.fixture(scope="module")
def shared():
    return build_shared()


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


def run_port_step(sh):
    """One port train_step from the shared state, in the shared schedule;
    the gradients are kept as they were before clipping."""
    st = port_state(sh)
    grads = {}

    def keep_then_clip(model):
        grads.update({n: p.grad.clone()
                      for n, p in model.named_parameters()})
        return O.clip_and_guard(model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "clip_and_guard", keep_then_clip)
        mp.setattr(raster_api, "COMPACT", sh["compact"])
        metrics = train_step(st, torch_batch(sh["batch"]), sh["draws"],
                             sh["cfg"])
    return st, metrics, grads


@pytest.fixture(scope="module")
def port_step(shared):
    return run_port_step(shared)


def check_losses_and_gradients(sh, port_step, loss_rtol=1e-4,
                               grad_rtol=2e-3):
    _, metrics, grads = port_step
    for k, v in sh["aux"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=loss_rtol, atol=1e-7, err_msg=k)
    assert set(grads) <= set(sh["grads"])
    close_per_leaf(grads, sh["grads"], grad_rtol, sorted(grads))


def check_update(sh, port_step, grad_rtol=2e-3, settled=1e-3):
    """Parameters, Adam moments and BatchNorm statistics after one step,
    and the step's group norms: moments and norms at grad_rtol (the second
    moment at 2.5x), parameters at 2e-7 where the gradient is above
    `settled` of its leaf's scale (its sign then agrees), else 1e-5."""
    st, metrics, _ = port_step
    assert st.step == 1 and float(metrics["bad_grad"]) == 0.0
    for k, v in sh["norms"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=grad_rtol, err_msg=k)
    new = st.model.state_dict()
    params = [n for n, _ in st.model.named_parameters()]
    for n in params:
        got, ref = new[n].numpy(), sh["new_params"][n].numpy()
        g = np.abs(sh["grads"][n].numpy())
        lim = np.where(g > max(settled * g.max(), 1e-6), 2e-7, 1e-5)
        assert (np.abs(got - ref) <= lim).all(), (n, np.abs(got - ref).max())
    trained = {id(p): n for g in st.optimizer.groups.values() for n, p in g}
    mu = {n: st.optimizer.adamw.state[p]["exp_avg"]
          for n, p in st.model.named_parameters() if id(p) in trained}
    nu = {n: st.optimizer.adamw.state[p]["exp_avg_sq"]
          for n, p in st.model.named_parameters() if id(p) in trained}
    close_per_leaf(mu, sh["mu"], grad_rtol, sorted(mu))
    close_per_leaf(nu, sh["nu"], 2.5 * grad_rtol, sorted(nu))
    stats = [n for n in new if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 26     # ResNet18: 20 BatchNorms, FPN: 6
    for n in stats:
        np.testing.assert_allclose(new[n].numpy(), sh["new_params"][n].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)


def test_losses_and_gradients_match_jax(shared, port_step):
    check_losses_and_gradients(shared, port_step)


def test_update_matches_jax(shared, port_step):
    check_update(shared, port_step)


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
                         env=dict(os.environ, JAX_PLATFORMS="cpu",
                                  **thread_env()))
    assert out.returncode == 0, out.stderr[-3000:]
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("iter ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out.stdout


def test_seed3_shard_render_vjp_matches_jax(shared, r=1):
    """ROADMAP C.13's split, the render's part: on the shard whose rotation
    head misses this file's bound through the render terms (row block r = 1
    of np_batch(seed=3, b=8), key fold_in(PRNGKey(7), 1)), the port's render
    VJP and the JAX Pallas VJP (interpret mode), given the same inputs and
    output cotangents (the port's, from every loss), agree within 2e-3 of
    the face-vertex gradient's largest entry (measured 1.6e-4 on both
    shards). So the render's backward does not carry the gap;
    tests/split_c13.py prints the rest of the split."""
    from selfcorr_tpu.ops.rasterizer import render_fused as jax_render
    from selfcorr_tpu_torch.models import meshnet as PM
    sh = shared
    rows = {k: torch.tensor(v[4 * r: 4 * (r + 1)])
            for k, v in np_batch(seed=3, b=8).items()}
    draws = jax_draws(jax.random.fold_in(jax.random.PRNGKey(7), r), 4,
                      sh["cfg"].symmetry_npts)
    seen = {}

    def keep(fv, soft, hard, size, **kw):
        seen["args"] = [x.detach().clone() for x in (fv, soft, hard)]
        out = raster_api.render_fused(fv, soft, hard, size, **kw)
        for v in out.values():
            if v.requires_grad:
                v.retain_grad()
        seen["out"] = out
        return out
    st = port_state(sh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PM, "render_fused", keep)
        total, _ = forward_train(st.model, st.dino, rows, st.constants,
                                 sh["cfg"], 0, draws)
        total.backward()
    cot = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
           .numpy() for k, v in seen["out"].items()}
    fv, soft, hard = (x.numpy() for x in seen["args"])
    fvt = torch.tensor(fv, requires_grad=True)
    out = raster_api.render_fused(fvt, torch.tensor(soft), torch.tensor(hard),
                                  32)
    sum((out[k] * torch.tensor(c)).sum() for k, c in cot.items()).backward()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "COMPACT", True)
        _, vjp = jax.vjp(lambda a: jax_render(a, soft, hard, 32,
                                              backend="pallas"), fv)
        want = np.asarray(vjp({k: jnp.asarray(c) for k, c in cot.items()})[0])
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(fvt.grad.numpy() - want).max()) <= 2e-3 * scale


ROT_HEAD = "encoder.pose_predictor.rot_pred_layer"


@pytest.fixture(scope="module")
def seed3_shard1():
    """ROADMAP C.13's shard: rows 4-7 of np_batch(seed=3, b=8), key
    fold_in(PRNGKey(7), 1). JAX forward_train's gradient there (Pallas in
    interpret mode) and the input of its pose head, img_code (the ResNet18's
    last feature map averaged, (4, 512)), from one compile."""
    import flax.linen as nn
    from selfcorr_tpu.models.heads import PosePredictor as JPose
    jcfg = JConfig(use_pallas=True, **TINY)
    constants = JM.build_mesh_constants(jcfg)
    state = jax.jit(lambda k: jax_init_state(jcfg, constants, k))(
        jax.random.PRNGKey(0))
    rows = {k: v[4:] for k, v in np_batch(seed=3, b=8).items()}
    key = jax.random.fold_in(jax.random.PRNGKey(7), 1)

    def loss_fn(params):
        seen = []

        def keep(next_fun, args, kwargs, context):
            if (isinstance(context.module, JPose)
                    and context.method_name == "__call__"):
                seen.append(args[0])
            return next_fun(*args, **kwargs)
        with nn.intercept_methods(keep):
            total, (aux, _) = JM.forward_train(
                params, state.batch_stats, state.dino_params,
                {k: jnp.asarray(v) for k, v in rows.items()}, constants,
                key, jcfg, 0)
        return total, seen[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "COMPACT", True)
        (_, code), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            state.params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(rows=rows, draws=jax_draws(key, 4, TINY["symmetry_npts"]),
                code=np.array(code),
                grads=W.from_jax_params(to_np(g), to_np(state.batch_stats)))


def port_rotation_head_grads(sh, rows, draws, code=None):
    """The port's gradient of the whole loss on `rows`, the rotation head's
    leaves; with `code` (4, 512) the pose head takes that value as its
    input in place of the port's own img_code (the gradient still flows
    through the port's)."""
    st = port_state(sh)
    pose = st.model.encoder.pose_predictor
    hook = None
    if code is not None:
        c = torch.as_tensor(code, dtype=torch.float32)
        hook = pose.register_forward_pre_hook(
            lambda m, a: (a[0] + (c - a[0]).detach(),))
    try:
        total, _ = forward_train(st.model, st.dino, torch_batch(rows),
                                 st.constants, sh["cfg"], 0, draws)
        total.backward()
    finally:
        if hook is not None:
            hook.remove()
    return {n: p.grad.clone() for n, p in st.model.named_parameters()
            if n.startswith(ROT_HEAD)}


def rotation_head_miss(got: dict, ref: dict) -> float:
    """The largest miss over the rotation head's leaves as a multiple of
    this file's per-leaf bound (2e-3 of the leaf's largest entry)."""
    return max(float((g - torch.as_tensor(ref[n])).abs().max())
               / max(2e-3 * float(np.abs(np.asarray(ref[n])).max()), 1e-7)
               for n, g in got.items())


def test_seed3_shard_rotation_head_gap_is_jax_rounding_past_a_kink(
        shared, seed3_shard1):
    """ROADMAP C.13, located: on the seed-3 shard 1 the rotation head's
    gradient misses this file's bound (10.7x) because of the value of the
    pose head's input, img_code, and nothing downstream of it.
    (a) Both packages' float32 img_code lie within float32 rounding of the
    float64 one (the port's, in float64): measured 2.3e-5 (JAX) and up to
    1.5e-4 (port; oneDNN on or off, 1 or 8 threads) of its scale 4.9, which
    layer4's BatchNorm over four rows at a 1 x 1 map amplifies ~30x over
    the earlier stages.
    (b) Given JAX's img_code, the port's rotation head holds this file's
    bound against JAX's gradient (measured 0.15x).
    (c) Given img_code halfway from the float64 value to JAX's, it holds it
    too (0.11x); given the float64 value itself it misses as the port does
    (10.9x): between the two the render losses' gradient with respect to
    row 2's rotation steps by 5.9e-6 (2.4e-3 of its scale) while every
    rendered plane moves by at most 4.6e-4 and every loss by 5.3e-8, a
    kink of the render's gradient, not of its value. JAX's rounding
    crosses it; the exact value and the port's rounding do not."""
    sh, j = shared, seed3_shard1
    rows, draws = j["rows"], j["draws"]
    # (a)
    x = preprocess(torch_batch(rows)["img"], draws.jitter)
    with torch.no_grad():
        exact = copy.deepcopy(sh["model"]).double().encoder.backbone(
            x.double())[-1].mean(dim=(1, 2))
        own = copy.deepcopy(sh["model"]).encoder.backbone(x)[-1].mean(
            dim=(1, 2))
    scale = float(exact.abs().max())
    for name, code in (("jax", torch.as_tensor(j["code"])), ("port", own)):
        err = float((code.double() - exact).abs().max()) / scale
        assert err <= 1e-3, (name, err)
    # (b)
    assert rotation_head_miss(port_rotation_head_grads(
        sh, rows, draws, j["code"]), j["grads"]) <= 1.0
    # (c)
    half = (exact + 0.5 * (torch.as_tensor(j["code"]).double() - exact))
    assert rotation_head_miss(port_rotation_head_grads(
        sh, rows, draws, half.float()), j["grads"]) <= 1.0
    assert rotation_head_miss(port_rotation_head_grads(
        sh, rows, draws, exact.float()), j["grads"]) > 5.0
