"""The port's surface-texture mode against the JAX package.

* models/surface_texture.py (barycentric_pattern, surface_texture,
  sample_surface_texture) against selfcorr_tpu/models/surface_texture.py.
* The tex_res arm of the rasterizer's plain versions, both schedules,
  against the JAX kernels `_fwd_call` / `_bwd_call(..., tex_res=R,
  interpret=True)`: the forward at the tolerances of
  tests/test_torch_raster.py, except the texture planes, where the texel
  lookup is discontinuous (cell + diagonal fold) and a pixel whose
  barycentrics land on a fold boundary may take the neighbouring texel
  after a last-bit difference: those are held by the outlier rule of
  tests/test_surface_texture.py:85-92 (under 1% of the pixels beyond
  2e-3); the backward as tests/test_torch_raster_bwd.py compares it, the
  texel slots taking the place of the soft-texture slots.
* Vertex and texel gradients through render_fused(surf_tex=) against
  jax.grad, and one train step with surface_texture=True, n_tex_sample=2
  against the JAX Pallas-interpret step.

The CUDA kernels' tex_res arms are held against the plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.models import surface_texture as JS
from selfcorr_tpu.ops.rasterizer import common as JC
from selfcorr_tpu.ops.rasterizer import pallas_raster as PR
from selfcorr_tpu.ops.rasterizer import render_fused as jax_render_fused
from selfcorr_tpu_torch.models import surface_texture as S
from selfcorr_tpu_torch.ops.rasterizer import api, common as C, kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import (
    BWD_GRADS, BWD_PLANES, PLANES, raster_fused_bwd_plain,
    raster_fused_fwd_plain, texel_index)
from tests.test_torch_raster import ATOL, S_RTOL
from tests.test_torch_raster_bwd import SIGMAS, _loss_jax, _loss_torch
from tests.test_torch_raster_chunk import (assert_bwd_close, chunk_bwd_case,
                                           chunk_fwd, jax_fwd, packed,
                                           surf_scene)
from tests.test_torch_train_step import (build_shared,
                                         check_losses_and_gradients,
                                         check_update, run_port_step)

TEX = ("texr", "texg", "texb")


@pytest.mark.parametrize("n", [2, 3, 6])
def test_barycentric_pattern_matches_jax(n):
    np.testing.assert_array_equal(S.barycentric_pattern(n),
                                  JS.barycentric_pattern(n))


def test_surface_texture_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(2, 16, 16, 3).astype(np.float32)
    imatch = rng.uniform(-1.1, 1.1, (2, 7, 2)).astype(np.float32)
    faces = np.array([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 0, 3]])
    got = S.surface_texture(torch.tensor(img), torch.tensor(imatch),
                            torch.tensor(faces), 3)
    ref = JS.surface_texture(jnp.asarray(img), jnp.asarray(imatch),
                             jnp.asarray(faces), 3)
    assert got.shape == (2, 4, 9, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_sample_surface_texture_matches_jax():
    rng = np.random.RandomState(1)
    res = 3
    tex = rng.rand(2, 5, res * res, 3).astype(np.float32)
    w = rng.dirichlet([1, 1, 1], (2, 5)).astype(np.float32)
    w[0, 0] = [1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0]     # on a fold boundary
    w[0, 1] = [1.0, 0.0, 0.0]                       # the clipped corner
    got = S.sample_surface_texture(torch.tensor(tex),
                                   *(torch.tensor(w[..., k])
                                     for k in range(3)), res)
    ref = JS.sample_surface_texture(jnp.asarray(tex),
                                    *(jnp.asarray(w[..., k])
                                      for k in range(3)), res)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_texel_index_is_the_kernels_selection():
    """reference.texel_index (floor, as the kernels take it) picks the
    texel sample_surface_texture picks for weights in [0, 1]."""
    rng = np.random.RandomState(2)
    w = rng.dirichlet([1, 1, 1], 4000).astype(np.float32)
    res = 6
    tex = np.broadcast_to(np.arange(res * res, dtype=np.float32)[:, None],
                          (4000, res * res, 3)).copy()
    want = S.sample_surface_texture(torch.tensor(tex),
                                    *(torch.tensor(w[:, k])
                                      for k in range(3)), res)[:, 0]
    got = texel_index(torch.tensor(w[:, 0]), torch.tensor(w[:, 1]), res)
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int64))


def assert_tex_planes_close(got, ref):
    """test_torch_raster's tolerances; the texture planes by the outlier
    rule (fold-boundary texel flips)."""
    for n in PLANES:
        assert np.isfinite(got[n]).all(), n
        if n in TEX:
            outliers = (np.abs(got[n] - ref[n]) > 2e-3).mean()
            assert outliers < 0.01, (n, outliers)
        elif n in ("s_d", "s_t"):
            err = np.abs(got[n] - ref[n]) / np.maximum(np.abs(ref[n]), 1.0)
            assert err.max() <= S_RTOL, (n, err.max())
        else:
            np.testing.assert_allclose(got[n], ref[n], atol=ATOL[n],
                                       err_msg=n)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("s,res", [(16, 2), (32, 3), (64, 2)])
def test_tex_res_forward_matches_pallas_interpret(s, res, compact):
    fv, st, ht, tex = surf_scene(5, 2, 12, res)
    got, ref = packed(fv, st, ht, s, tex)
    if compact:
        planes = {k: v.numpy() for k, v in raster_fused_fwd_plain(
            got, s, *SIGMAS, res).items()}
    else:
        planes = chunk_fwd(got, s, SIGMAS[3], res)
    want = jax_fwd(ref, s, SIGMAS[3], compact=compact, tex_res=res)
    assert_tex_planes_close(planes, want)
    # the texels do reach the planes: the soft texture takes no part
    assert np.abs(planes["texr"] - jax_fwd(
        PR.pack_constants(jnp.asarray(fv), jnp.asarray(st), jnp.asarray(ht),
                          n_bands=PR.bands_for(s)), s, SIGMAS[3],
        compact=compact)["texr"]).max() > 0.05


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("s", [16, 64])
def test_tex_res_backward_matches_pallas_interpret(s, compact, mxu):
    """Each face's texels share one colour (see assert_bwd_close: a texel
    flip at a fold boundary then moves a pixel's gradient between texels
    of one face and changes nothing else); the routing to single texels is
    held by the render gradients below."""
    fv, st, ht, tex = surf_scene(6, 2, 12, 2)
    tex = np.repeat(tex[:, :, :1], 4, axis=2)
    if not compact:
        got, ref = chunk_bwd_case(fv, st, ht, s, mxu, tex)
    else:
        got_c, ref_c = packed(fv, st, ht, s, tex)
        planes = raster_fused_fwd_plain(got_c, s, *SIGMAS, 2)
        rng = np.random.RandomState(11)
        grads = {n: torch.tensor(rng.randn(2, s, s).astype(np.float32))
                 for n in BWD_GRADS}
        got = raster_fused_bwd_plain(got_c, planes, grads, s, *SIGMAS,
                                     2).numpy()
        ref = np.asarray(PR._bwd_call(
            ref_c, {n: jnp.asarray(planes[n].numpy()) for n in BWD_PLANES},
            {n: jnp.asarray(grads[n].numpy()) for n in BWD_GRADS}, s,
            *SIGMAS, JC.NEAR, JC.FAR, JC.BG_EPS, JC.EYE_OFFSET,
            interpret=True, tex_res=2, mxu_reduce=mxu,
            lane_split=PR.lane_split_for(s), compact=True))
    assert np.abs(got[..., C.S_SURF:C.S_SURF + 12]).max() > 0
    assert_bwd_close(got, ref, fv, st, ht, s, tex)


@pytest.mark.parametrize("compact", [True, False])
def test_surface_render_gradients_match_jax(compact, monkeypatch):
    """Vertex and texel gradients through render_fused(surf_tex=) on both
    sides, in one schedule (5e-3 of the largest entry, as
    tests/test_surface_texture.py:95-118)."""
    monkeypatch.setattr(api, "COMPACT", compact)
    monkeypatch.setattr(PR, "COMPACT", compact)
    fv, st, ht, tex = surf_scene(2, 1, 4, 2)
    f = torch.tensor(fv, requires_grad=True)
    t = torch.tensor(tex, requires_grad=True)
    s_tex = torch.tensor(st, requires_grad=True)
    before = dict(kernel.LAUNCHES)
    _loss_torch(api.render_fused(f, s_tex, torch.tensor(ht), 16,
                                 surf_tex=t)).backward()
    assert kernel.LAUNCHES == before
    assert s_tex.grad is None or not s_tex.grad.any()

    def jloss(fv_, tex_):
        return _loss_jax(jax_render_fused(fv_, jnp.asarray(st),
                                          jnp.asarray(ht), 16,
                                          interpret=True, surf_tex=tex_))
    gv, gt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(fv),
                                             jnp.asarray(tex))
    for got, ref, name in ((f.grad, gv, "verts"), (t.grad, gt, "surf_tex")):
        ref = np.asarray(ref)
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=5e-3, err_msg=name)
    assert np.abs(t.grad.numpy()).max() > 0


def test_tex_res_must_match_the_packing():
    fv, st, ht, tex = surf_scene(1, 1, 4, 2)
    consts, _ = packed(fv, st, ht, 16, tex)
    assert consts.shape[-1] == C.k_for(2) == 128
    assert C.k_for(6) == 192 and C.k_for(0) == 64
    with pytest.raises(ValueError, match="tex_res"):
        raster_fused_fwd_plain(consts, 16, *SIGMAS)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.raster_fused_fwd_cuda(consts, 16, *SIGMAS, 2)


@pytest.fixture(scope="module", params=[1, 2])
def surface_step(request):
    sh = build_shared(surface_texture=True, n_tex_sample=request.param)
    return request.param, sh, run_port_step(sh)


# Tolerances of the train step at R = 2. The two packages form the
# barycentrics with another rounding (XLA contracts a*x + c into one fused
# multiply-add; the port rounds each operation), and a pixel whose
# barycentrics sit on a texel fold boundary then takes another texel: every
# pixel just outside a face's edge v0 -> v1 does (c2 clips to 0, so c0 + c1
# = 1 up to the last bit, on the fold), about 0.5% of the pixels at this
# size. Measured at R = 2: texture loss 2.2e-4 relative (the other losses
# 3.2e-5), per-leaf gradients 3.0e-2 of the leaf's scale (the rotation
# head, whose gradient comes through the render's edges); at R = 1, one
# texel per face and no fold, the step holds the tolerances of the vertex-
# colour step (texture loss 7.1e-6, gradients 5.7e-4).
FOLD = dict(loss_rtol=1e-3, grad_rtol=5e-2)


def test_surface_train_step_losses_and_gradients_match_jax(surface_step):
    """One step with --surface_texture at R = 1 and R = 2 against the JAX
    step, which renders the texels through the Pallas kernels' tex_res arm:
    aux losses and per-leaf gradients. Before this mode was ported the
    port ignored the flag and trained the vertex-colour texture loss."""
    res, sh, step = surface_step
    check_losses_and_gradients(sh, step, **(FOLD if res > 1 else {}))


def test_surface_train_step_update_matches_jax(surface_step):
    res, sh, step = surface_step
    check_update(sh, step, **(dict(grad_rtol=FOLD["grad_rtol"],
                                   settled=FOLD["grad_rtol"])
                              if res > 1 else {}))
