"""The port's dense-chunk rasterizer schedule and face packing against the
JAX package.

* common.pack_constants (faces sorted by y-band and x, padded to a multiple
  of 16, with and without surface texels) equals pallas_raster.
  pack_constants exactly, and its VJP through the sort equals jax.vjp.
* chunks.compute_chunk_info equals pallas_raster.compute_chunk_info exactly
  on both tile geometries (8 x min(128, S) at S 16 / 32, 16 x 64 at S 64).
* The dense-chunk plain versions (reference.raster_fused_{fwd,bwd}_chunk_
  plain) against the JAX dense-chunk kernels `_fwd_call` / `_bwd_call(...,
  compact=False, interpret=True)`, the backward under both reduction arms
  (`mxu_reduce` False and True), at the tolerances and by the comparisons
  of tests/test_torch_raster.py and tests/test_torch_raster_bwd.py; the
  forward also against the compact plain version within 1e-5.
* Gradients through render_fused with api.COMPACT = False against jax.grad
  with pallas_raster.COMPACT = False, and one train step in that schedule
  against the JAX Pallas-interpret step (tests/test_torch_train_step.py's
  tolerances).

The CUDA kernels B1' / B2' are held against the plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.ops.rasterizer import common as JC
from selfcorr_tpu.ops.rasterizer import pallas_raster as PR
from selfcorr_tpu.ops.rasterizer import render_fused as jax_render_fused
from selfcorr_tpu_torch.ops.rasterizer import api, chunks as CH
from selfcorr_tpu_torch.ops.rasterizer import common as C, kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import (
    BWD_GRADS, BWD_PLANES, PLANES, raster_fused_bwd_chunk_plain,
    raster_fused_fwd_chunk_plain, raster_fused_fwd_plain)
from tests.test_torch_raster import (SCENES, assert_planes_close,
                                     make_scene)
from tests.test_torch_raster_bwd import SIGMAS, _loss_jax, _loss_torch
from tests.test_torch_train_step import (build_shared, check_losses_and_gradients,
                                         check_update, run_port_step)

JAX_PAD = math.sqrt(1e-3 * JC.DIST_CUT)    # pallas_raster.py:1293


def surf_scene(seed, b, nf, res):
    fv, st, ht = make_scene(seed=seed, b=b, n_faces=nf)
    rng = np.random.RandomState(seed + 100)
    return fv, st, ht, rng.rand(b, nf, res * res, 3).astype(np.float32)


def packed(fv, st, ht, s, surf=None):
    """Both packages' constants for image size s; the port's as torch."""
    got = C.pack_constants(torch.tensor(fv), torch.tensor(st),
                           torch.tensor(ht), n_bands=C.bands_for(s),
                           surf_tex=None if surf is None
                           else torch.tensor(surf))
    ref = PR.pack_constants(jnp.asarray(fv), jnp.asarray(st),
                            jnp.asarray(ht), n_bands=PR.bands_for(s),
                            surf_tex=None if surf is None
                            else jnp.asarray(surf))
    return got, ref


@pytest.mark.parametrize("surf", [False, True])
@pytest.mark.parametrize("nf", [9, 21])
@pytest.mark.parametrize("s", [16, 64])
def test_sorted_packing_matches_jax(s, nf, surf):
    fv, st, ht, tex = surf_scene(nf, 2, nf, 3)
    got, ref = packed(fv, st, ht, s, tex if surf else None)
    f_pad = -(-nf // C.FF) * C.FF
    assert got.shape == ref.shape == (2, f_pad, 128 if surf else 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("surf", [False, True])
def test_packing_vjp_matches_jax(surf):
    """The gradient of the packing un-sorts, drops the padding rows and
    detaches the hard texture, as jax.vjp of pallas_raster.pack_constants
    does."""
    fv, st, ht, tex = surf_scene(4, 2, 21, 2)
    rng = np.random.RandomState(1)
    dc = rng.randn(2, 32, 128 if surf else 64).astype(np.float32)
    args = [fv, st, ht] + ([tex] if surf else [])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = C.pack_constants(ts[0], ts[1], ts[2],
                           surf_tex=ts[3] if surf else None)
    (out * torch.tensor(dc)).sum().backward()

    def jpack(*a):
        return PR.pack_constants(a[0], a[1], a[2],
                                 surf_tex=a[3] if surf else None)
    _, vjp = jax.vjp(jpack, *(jnp.asarray(a) for a in args))
    refs = vjp(jnp.asarray(dc))
    for i, (t, r) in enumerate(zip(ts, refs)):
        if i == 2:
            assert t.grad is None and not np.asarray(r).any()
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5 * np.abs(r).max(),
                                   err_msg=str(i))


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("s", [16, 32, 64])
def test_chunk_info_matches_jax(scene, s):
    fv, st, ht = SCENES[scene]()
    got, ref = packed(fv, st, ht, s)
    spans, masks = CH.compute_chunk_info(got, s, JAX_PAD)
    jspans, jmasks = PR.compute_chunk_info(ref, s, JAX_PAD,
                                           PR.lane_split_for(s))
    assert spans.dtype == masks.dtype == torch.int32
    np.testing.assert_array_equal(spans.numpy(), np.asarray(jspans))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))


def test_chunk_info_bit_31():
    """47 chunks: the second mask word is used, and the first word's bit 31
    (a negative int32) is set somewhere."""
    fv, st, ht = make_scene(seed=3, b=2, n_faces=740, size=0.15)
    got, ref = packed(fv, st, ht, 64)
    spans, masks = CH.compute_chunk_info(got, 64, 0.1)
    jspans, jmasks = PR.compute_chunk_info(ref, 64, 0.1, True)
    np.testing.assert_array_equal(spans.numpy(), np.asarray(jspans))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    assert (masks < 0).any() and masks.shape == (2, 4 * 2)


def chunk_fwd(consts, s, gamma_t, tex_res=0):
    spans, masks = api.chunk_info(consts, s, 1e-4, 1e-3)
    out = raster_fused_fwd_chunk_plain(consts, spans, masks, s, 1e-4, 1e-3,
                                       1e-4, gamma_t, tex_res)
    return {k: v.numpy() for k, v in out.items()}


def jax_fwd(ref, s, gamma_t, compact=False, tex_res=0):
    out = PR._fwd_call(ref, s, 1e-4, 1e-3, 1e-4, gamma_t, JC.NEAR, JC.FAR,
                       JC.BG_EPS, JC.EYE_OFFSET, interpret=True,
                       tex_res=tex_res, lane_split=PR.lane_split_for(s),
                       compact=compact)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("scene,gamma_t,s", [
    (sc, g, s) for sc in sorted(SCENES) for g in (1e-2, 1e-4)
    for s in (16, 32)] + [("padded_F21", 1e-2, 64)])
def test_chunk_plain_matches_pallas_interpret(scene, gamma_t, s):
    fv, st, ht = SCENES[scene]()
    got, ref = packed(fv, st, ht, s)
    planes = chunk_fwd(got, s, gamma_t)
    assert_planes_close(planes, jax_fwd(ref, s, gamma_t))
    compact = raster_fused_fwd_plain(got, s, 1e-4, 1e-3, 1e-4, gamma_t)
    for n in PLANES:
        err = np.abs(planes[n] - compact[n].numpy())
        if n in ("s_d", "s_t"):
            err = err / np.maximum(np.abs(compact[n].numpy()), 1.0)
        assert err.max() <= 1e-5, (n, err.max())


def test_chunk_cull_is_visible():
    """A chunk the cull wrongly drops changes the planes: the gate is
    live, so a wrong span or mask cannot pass the comparisons above."""
    fv, st, ht = make_scene(seed=0, b=1, n_faces=5, size=0.3)
    fv[..., 1] = fv[..., 1] * 0.3 + 0.6       # all in the top quarter
    got, _ = packed(fv, st, ht, 32)
    spans, masks = api.chunk_info(got, 32, 1e-4, 1e-3)
    visit = CH.visited_chunks(spans, masks, 32, 1)
    assert visit.any() and not visit.all()
    full = raster_fused_fwd_chunk_plain(got, spans, masks, 32, *SIGMAS)
    assert_planes_close({k: v.numpy() for k, v in full.items()},
                        {k: v.numpy() for k, v in raster_fused_fwd_plain(
                            got, 32, *SIGMAS).items()})
    none = raster_fused_fwd_chunk_plain(got, spans, torch.zeros_like(masks),
                                        32, *SIGMAS)
    assert float(full["alpha2"].max()) > 0.5
    assert float(none["alpha2"].abs().max()) == 0.0


def chunk_bwd_case(fv, st, ht, s, mxu, tex=None, seed=11):
    """The port's chunk plain backward and the JAX dense-chunk backward on
    the same sorted constants, planes and cotangents."""
    tex_res = 0 if tex is None else math.isqrt(tex.shape[2])
    got_c, ref_c = packed(fv, st, ht, s, tex)
    spans, masks = api.chunk_info(got_c, s, 1e-4, 1e-3)
    planes = raster_fused_fwd_chunk_plain(got_c, spans, masks, s, *SIGMAS,
                                          tex_res)
    b = fv.shape[0]
    rng = np.random.RandomState(seed)
    grads = {n: torch.tensor(rng.randn(b, s, s).astype(np.float32))
             for n in BWD_GRADS}
    got = raster_fused_bwd_chunk_plain(got_c, spans, masks, planes, grads,
                                       s, *SIGMAS, tex_res).numpy()
    ref = np.asarray(PR._bwd_call(
        ref_c, {n: jnp.asarray(planes[n].numpy()) for n in BWD_PLANES},
        {n: jnp.asarray(grads[n].numpy()) for n in BWD_GRADS}, s, *SIGMAS,
        JC.NEAR, JC.FAR, JC.BG_EPS, JC.EYE_OFFSET, interpret=True,
        tex_res=tex_res, mxu_reduce=mxu, lane_split=PR.lane_split_for(s),
        compact=False))
    return got, ref


def vjp_of_packing(fv, st, ht, s, dconsts, tex=None):
    """d/d(vertices), d/d(soft texture or texels) for d/d(constants)."""
    f = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(st if tex is None else tex, requires_grad=True)
    consts = C.pack_constants(f, t if tex is None else torch.tensor(st),
                              torch.tensor(ht), n_bands=C.bands_for(s),
                              surf_tex=None if tex is None else t)
    (consts * torch.as_tensor(dconsts)).sum().backward()
    return f.grad.numpy(), t.grad.numpy()


def texel_sums(a, n):
    """(..., K) gradient -> the soft-texture-like (..., 3) sums of each
    face's n texel slots."""
    return a[..., C.S_SURF:C.S_SURF + 3 * n].reshape(
        *a.shape[:-1], n, 3).sum(-2)


def assert_bwd_close(got, ref, fv, st, ht, s, tex=None, slot_check=True):
    """As tests/test_torch_raster_bwd.py compares: zero slots, the 1/z, z
    and texture slots one by one (1e-3 of each slot's largest; not across
    the near plane), the edge slots through the packing's VJP (5e-4 of the
    largest entry). The padding rows get no gradient here; the Pallas
    kernel can write NaN into them (0 * inf), which the VJP drops.

    With surface texels `tex` the texel slots are compared as each face's
    sum over its texels, and so is their VJP: which texel a pixel outside
    a face's edge falls in turns on the last bit of c0 + c1 (there c2 is
    clipped to 0 and c0 + c1 = 1 sits on the fold), and the two packages
    form the barycentrics in another order. The callers give each face
    one colour in all its texels, so a flip moves a pixel's gradient to a
    neighbouring texel of the same face and changes nothing else."""
    b, nf = fv.shape[:2]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert (got[:, nf:] == 0).all()
    got, ref = got[:, :nf], ref[:, :nf]
    n_tex = 0 if tex is None else tex.shape[2]
    tex_slots = (list(range(C.S_STEX, C.S_HTEX)) if tex is None else
                 list(range(C.S_SURF, C.S_SURF + 3 * n_tex)))
    live = set(range(C.S_SEG, C.S_FRONT)) | set(tex_slots)
    zero = [j for j in range(got.shape[-1]) if j not in live]
    assert (got[..., zero] == 0).all() and (ref[..., zero] == 0).all()
    if slot_check:
        slots = list(range(C.S_IZ, C.S_FRONT))
        g_s, r_s = got[..., slots], ref[..., slots]
        if tex is None:
            slots += tex_slots
            g_s, r_s = got[..., slots], ref[..., slots]
        else:
            g_s = np.concatenate([g_s, texel_sums(got, n_tex)], -1)
            r_s = np.concatenate([r_s, texel_sums(ref, n_tex)], -1)
        scale = np.abs(r_s).max(axis=(0, 1)) + 1e-12
        assert (np.abs(g_s - r_s).max(axis=(0, 1)) <= 1e-3 * scale).all()
    pad = np.zeros((b, -(-nf // C.FF) * C.FF - nf, got.shape[-1]),
                   np.float32)
    for i, (g, r) in enumerate(zip(
            vjp_of_packing(fv, st, ht, s, np.concatenate([got, pad], 1), tex),
            vjp_of_packing(fv, st, ht, s, np.concatenate([ref, pad], 1),
                           tex))):
        if i == 1 and tex is not None:
            g, r = g.sum(-2), r.sum(-2)
        np.testing.assert_allclose(g, r, atol=5e-4 * np.abs(r).max(), rtol=0)


BWD_SCENES = ("random", "padded_F21", "near_plane")


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("scene,s", [(sc, s) for sc in BWD_SCENES
                                     for s in (16, 32)]
                         + [("padded_F21", 64)])
def test_chunk_plain_backward_matches_pallas_interpret(scene, s, mxu):
    fv, st, ht = SCENES[scene]()
    got, ref = chunk_bwd_case(fv, st, ht, s, mxu)
    assert_bwd_close(got, ref, fv, st, ht, s,
                     slot_check=scene != "near_plane")


@pytest.mark.parametrize("s", [16, 64])
def test_chunk_render_gradients_match_jax(s, monkeypatch):
    """Vertex and soft-texture gradients through render_fused in the
    dense-chunk schedule on both sides (5e-3 of the largest entry, as
    tests/test_raster_pallas.py:67-88)."""
    monkeypatch.setattr(api, "COMPACT", False)
    monkeypatch.setattr(PR, "COMPACT", False)
    fv, st, ht = make_scene(seed=1, b=1, n_faces=4, size=0.9)
    f = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(st, requires_grad=True)
    before = dict(kernel.LAUNCHES)
    _loss_torch(api.render_fused(f, t, torch.tensor(ht), s)).backward()
    assert kernel.LAUNCHES == before

    def jloss(fv_, st_):
        return _loss_jax(jax_render_fused(fv_, st_, jnp.asarray(ht), s,
                                          interpret=True))
    gv, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(fv), jnp.asarray(st))
    for got, ref, name in ((f.grad, gv, "verts"), (t.grad, gt, "soft_tex")):
        ref = np.asarray(ref)
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=5e-3, err_msg=name)


def test_chunk_wrappers_refuse_cpu_tensors(monkeypatch):
    """The B1' / B2' wrappers never run a CPU tensor; render_fused on CPU
    tensors takes the chunk plain versions without counting a launch."""
    fv, st, ht = make_scene()
    consts, _ = packed(fv, st, ht, 16)
    spans, masks = api.chunk_info(consts, 16, 1e-4, 1e-3)
    planes = raster_fused_fwd_chunk_plain(consts, spans, masks, 16, *SIGMAS)
    grads = {n: torch.ones(2, 16, 16) for n in BWD_GRADS}
    with pytest.raises(ValueError, match="CUDA"):
        kernel.raster_fused_fwd_chunk_cuda(consts, spans, masks, 16, *SIGMAS)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.raster_fused_bwd_chunk_cuda(consts, spans, masks, planes,
                                           grads, 16, *SIGMAS)
    monkeypatch.setattr(api, "COMPACT", False)
    before = dict(kernel.LAUNCHES)
    f = torch.tensor(fv, requires_grad=True)
    out = api.render_fused(f, torch.tensor(st), torch.tensor(ht), 16)
    out["alpha2"].sum().backward()
    assert kernel.LAUNCHES == before and f.grad is not None
    for n in ("alpha1", "alpha2", "depth"):
        assert torch.equal(out[n].detach(), planes[n]), n


def test_empty_scene_chunk_schedule(monkeypatch):
    monkeypatch.setattr(api, "COMPACT", False)
    z = torch.zeros((2, 0, 3, 3), requires_grad=True)
    out = api.render_fused(z, z, z, 8)
    _loss_torch(out).backward()
    assert z.grad.shape == (2, 0, 3, 3)
    assert (out["alpha1"] == 0).all() and (out["depth"] == 1).all()


@pytest.fixture(scope="module")
def chunk_step():
    sh = build_shared(compact=False)
    return sh, run_port_step(sh)


def test_chunk_train_step_losses_and_gradients_match_jax(chunk_step):
    """One step with api.COMPACT = False against the JAX step with
    pallas_raster.COMPACT = False: aux losses and per-leaf gradients."""
    check_losses_and_gradients(*chunk_step)


def test_chunk_train_step_update_matches_jax(chunk_step):
    check_update(*chunk_step)
