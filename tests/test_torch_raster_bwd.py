"""The port's fused rasterizer backward against the JAX package.

* The plain backward `raster_fused_bwd_plain` against the JAX Pallas
  backward `_bwd_call(..., interpret=True, compact=True)` on the same
  constants (sorted and padded by each package's pack_constants, which
  agree exactly), forward planes and cotangents.
  Where the nearest boundary point is a triangle corner, the two edges that
  meet there tie for the distance, and which one the kernel calls the
  "first minimizing edge" depends on the last bit of each edge's distance
  (the Pallas kernel forms |p - v0|^2 in another order). Both edges carry
  the same gradient to the corner, so the packed edge slots are compared
  through the packing's own VJP, as vertex and texture gradients (5e-4 of
  the largest entry, measured 3.5e-4); the 1/z, z and texture slots, which
  no tie touches, are compared slot by slot (1e-3 of each slot's largest
  entry, measured 5.1e-4) in the scenes without faces across the near
  plane: there z_ok flips at a rounding boundary and single slots differ
  by up to 1.5% while the vertex gradients still agree.
* The port's render_fused gradients (vertices and soft texture, through
  RasterFused) against jax.grad through the JAX render_fused, dense and
  Pallas-interpret backends, at the tolerances of
  tests/test_raster_pallas.py:67-88 (5e-3 of the largest entry).
* The hard texture takes no gradient; empty scenes; face counts that are not
  a multiple of the Pallas kernel's 16-face chunk.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.ops.rasterizer import common as JC
from selfcorr_tpu.ops.rasterizer import pallas_raster as PR
from selfcorr_tpu.ops.rasterizer import render_fused as jax_render_fused
from selfcorr_tpu_torch.ops.rasterizer import api, common as C, kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import (
    BWD_GRADS, BWD_PLANES, raster_fused_bwd_plain, raster_fused_fwd_plain)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIGMAS = (1e-4, 1e-3, 1e-4, 1e-2)


def make_scene(seed=0, b=2, n_faces=5, size=0.7, z0=5.0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.5, 0.5, (b, n_faces, 1, 2))
    tri = rng.uniform(-size / 2, size / 2, (b, n_faces, 3, 2))
    xy = np.clip(centers + tri, -0.95, 0.95)
    z = z0 + rng.uniform(-1.0, 1.0, (b, n_faces, 3, 1))
    fv = np.concatenate([xy, z], axis=-1).astype(np.float32)
    return (fv, rng.rand(b, n_faces, 3, 3).astype(np.float32),
            rng.rand(b, n_faces, 3, 3).astype(np.float32))


def near_scene():
    fv, st, ht = make_scene(seed=5, b=2, n_faces=10, size=0.9)
    fv[:, :5, 0, 2] = 0.5
    fv[:, 5:, 1, 2] = -0.7
    return fv, st, ht


SCENES = {
    "random": lambda: make_scene(seed=0, b=2, n_faces=9),
    "padded_F21": lambda: make_scene(seed=3, b=1, n_faces=21),
    "near_plane": near_scene,
}


def vjp_of_packing(fv, st, ht, dconsts, n_bands=C.N_BANDS):
    """d/d(vertices), d/d(soft texture) for a given d/d(constants), through
    the sort and the padding."""
    f = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(st, requires_grad=True)
    consts = C.pack_constants(f, t, torch.tensor(ht), n_bands=n_bands)
    (consts * torch.as_tensor(dconsts)).sum().backward()
    return f.grad.numpy(), t.grad.numpy()


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("s", [16, 32])
def test_plain_backward_matches_pallas_interpret(scene, s):
    fv, st, ht = SCENES[scene]()
    b, nf = fv.shape[:2]
    consts = C.pack_constants(torch.tensor(fv), torch.tensor(st),
                              torch.tensor(ht), n_bands=C.bands_for(s))
    planes = raster_fused_fwd_plain(consts, s, *SIGMAS)
    rng = np.random.RandomState(11)
    grads = {n: torch.tensor(rng.randn(b, s, s).astype(np.float32))
             for n in BWD_GRADS}
    got = raster_fused_bwd_plain(consts, planes, grads, s, *SIGMAS).numpy()
    jconsts = PR.pack_constants(jnp.asarray(fv), jnp.asarray(st),
                                jnp.asarray(ht), n_bands=PR.bands_for(s))
    np.testing.assert_array_equal(consts.numpy(), np.asarray(jconsts))
    ref = np.asarray(PR._bwd_call(
        jconsts,
        {n: jnp.asarray(planes[n].numpy()) for n in BWD_PLANES},
        {n: jnp.asarray(grads[n].numpy()) for n in BWD_GRADS},
        s, *SIGMAS, JC.NEAR, JC.FAR, JC.BG_EPS, JC.EYE_OFFSET,
        interpret=True, lane_split=PR.lane_split_for(s),
        compact=True))
    f_pad = -(-nf // C.FF) * C.FF
    assert got.shape == ref.shape == (b, f_pad, C.K)
    assert np.isfinite(got).all()
    # the padding faces (rows nf.. after the sort) get no gradient; the
    # Pallas kernel writes NaN into some of their 1/z slots (0 * inf at
    # their infinite depth), which the packing's VJP drops with them
    assert (got[:, nf:] == 0).all()
    got, ref = got[:, :nf], ref[:, :nf]
    zero = [j for j in range(C.K) if not (C.S_SEG <= j < C.S_FRONT
                                          or C.S_STEX <= j < C.S_HTEX)]
    assert (got[..., zero] == 0).all() and (ref[..., zero] == 0).all()
    if scene != "near_plane":
        slots = list(range(C.S_IZ, C.S_FRONT)) + list(range(C.S_STEX,
                                                              C.S_HTEX))
        scale = np.abs(ref[..., slots]).max(axis=(0, 1)) + 1e-12
        assert (np.abs(got[..., slots] - ref[..., slots]).max(axis=(0, 1))
                <= 1e-3 * scale).all()
    nb = C.bands_for(s)
    pad = np.zeros((b, f_pad - nf, C.K), np.float32)
    for g, r in zip(
            vjp_of_packing(fv, st, ht, np.concatenate([got, pad], 1), nb),
            vjp_of_packing(fv, st, ht, np.concatenate([ref, pad], 1), nb)):
        np.testing.assert_allclose(g, r, atol=5e-4 * np.abs(r).max(), rtol=0)


def _loss_torch(out, keys=("alpha1", "alpha2", "depth", "tex")):
    return sum(torch.sin(out[k] * (0.7 + 0.1 * i)).sum()
               for i, k in enumerate(keys))


def _loss_jax(out, keys=("alpha1", "alpha2", "depth", "tex")):
    return sum(jnp.sum(jnp.sin(out[k] * (0.7 + 0.1 * i)))
               for i, k in enumerate(keys))


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_render_gradients_match_jax(backend):
    """The scene and loss of tests/test_raster_pallas.py
    test_gradients_match_dense."""
    fv, st, ht = make_scene(seed=1, b=1, n_faces=4, size=0.9)
    f = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(st, requires_grad=True)
    _loss_torch(api.render_fused(f, t, torch.tensor(ht), 16)).backward()

    def jloss(fv_, st_):
        return _loss_jax(jax_render_fused(fv_, st_, jnp.asarray(ht), 16,
                                          backend=backend, interpret=True))
    gv, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(fv), jnp.asarray(st))
    for got, ref, name in ((f.grad, gv, "verts"), (t.grad, gt, "soft_tex")):
        ref = np.asarray(ref)
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=5e-3, err_msg=name)


def test_hard_texture_takes_no_gradient():
    """pack_constants detaches the hard texture, as pallas_raster.py:165
    does; before that repair its slots carried gradient back to it."""
    fv, st, ht = make_scene(seed=2)
    h = torch.tensor(ht, requires_grad=True)
    consts = C.pack_constants(torch.tensor(fv), torch.tensor(st), h)
    assert not consts[..., C.S_HTEX:C.S_HTEX + 9].requires_grad
    f = torch.tensor(fv, requires_grad=True)
    out = api.render_fused(f, torch.tensor(st), h, 16)
    assert not out["match"].requires_grad
    (out["alpha1"].sum() + out["tex"].sum()).backward()
    assert h.grad is None and f.grad is not None


def test_empty_scene_backward():
    z = torch.zeros((2, 0, 3, 3), requires_grad=True)
    out = api.render_fused(z, z, z, 8)
    _loss_torch(out).backward()
    assert z.grad.shape == (2, 0, 3, 3)
    consts = C.pack_constants(z, z, z)
    planes = raster_fused_fwd_plain(consts, 8, *SIGMAS)
    grads = {n: torch.ones(2, 8, 8) for n in BWD_GRADS}
    assert raster_fused_bwd_plain(consts, planes, grads, 8,
                                  *SIGMAS).shape == (2, 0, C.K)


def test_face_chunking_is_exact():
    fv, st, ht = make_scene(seed=4, b=2, n_faces=23)
    consts = C.pack_constants(*(torch.tensor(a) for a in (fv, st, ht)))
    planes = raster_fused_fwd_plain(consts, 16, *SIGMAS)
    rng = np.random.RandomState(3)
    grads = {n: torch.tensor(rng.randn(2, 16, 16).astype(np.float32))
             for n in BWD_GRADS}
    one = raster_fused_bwd_plain(consts, planes, grads, 16, *SIGMAS,
                                 faces_per_chunk=64)
    for fc in (1, 5):
        many = raster_fused_bwd_plain(consts, planes, grads, 16, *SIGMAS,
                                      faces_per_chunk=fc)
        torch.testing.assert_close(many, one, rtol=1e-5, atol=1e-6)


def test_backward_wrapper_refuses_cpu_tensors():
    """The CUDA backward wrapper never runs a CPU tensor, and autograd on
    CPU tensors takes the plain backward without counting a launch."""
    fv, st, ht = make_scene()
    consts = C.pack_constants(*(torch.tensor(a) for a in (fv, st, ht)))
    planes = raster_fused_fwd_plain(consts, 16, *SIGMAS)
    grads = {n: torch.ones(2, 16, 16) for n in BWD_GRADS}
    with pytest.raises(ValueError, match="CUDA"):
        kernel.raster_fused_bwd_cuda(consts, planes, grads, 16, *SIGMAS)
    before = dict(kernel.LAUNCHES)
    f = torch.tensor(fv, requires_grad=True)
    api.render_fused(f, torch.tensor(st), torch.tensor(ht), 16)[
        "alpha2"].sum().backward()
    assert kernel.LAUNCHES == before and f.grad is not None
