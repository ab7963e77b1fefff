"""The port's fused rasterizer forward against the JAX package.

The plain PyTorch version (selfcorr_tpu_torch/ops/rasterizer/reference.py)
is held, all 13 planes, against the JAX Pallas kernel run in interpret mode
(`_fwd_call(..., interpret=True)`, the compact kernel the TPU runs) and
against the JAX dense reference `render_fused_dense`. The CUDA kernel itself
is checked against the plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py).

Tolerances are those of tests/test_raster_pallas.py: alpha / tex / match
2e-3, depth 2e-2 (the sigma = 1e-4 sigmoid amplifies rounding ~1e4x at
triangle edges; the Pallas kernel derives its sigma1 sigmoid from the sigma2
exponential by exponentiation). Both packages sort the faces the same way
at packing, so both walk them in one order and the match plane's "earliest
face wins exact z-ties" picks the same face.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.ops.rasterizer import common as JC
from selfcorr_tpu.ops.rasterizer import pallas_raster as PR
from selfcorr_tpu.ops.rasterizer.reference import render_fused_dense
from selfcorr_tpu_torch.ops.rasterizer import api, common as C, kernel
from selfcorr_tpu_torch.ops.rasterizer.reference import (
    PLANES, raster_fused_fwd_plain)

ATOL = {"alpha1": 2e-3, "alpha2": 2e-3, "depth": 2e-2,
        "texr": 2e-3, "texg": 2e-3, "texb": 2e-3,
        "matr": 2e-3, "matg": 2e-3, "matb": 2e-3,
        "m_d": 1e-5, "m_t": 1e-5}
# softmax sums, relative to max(1, |s|): the weights carry the coverage
# error, and at gamma_d = 1e-4 one ulp of normalized depth (6e-8) moves a
# weight exp(zn / gamma) by 6e-4
S_RTOL = 5e-3


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
    """Faces with rasterizer-space z below NEAR on some corners."""
    fv, st, ht = make_scene(seed=5, b=2, n_faces=10, size=0.9)
    fv[:, :5, 0, 2] = 0.5
    fv[:, 5:, 1, 2] = -0.7
    return fv, st, ht


def offscreen_scene():
    fv, st, ht = make_scene(seed=6, b=2, n_faces=6)
    fv[..., :2] += 4.0
    return fv, st, ht


SCENES = {
    "random": lambda: make_scene(seed=0, b=2, n_faces=9),
    "padded_F21": lambda: make_scene(seed=3, b=1, n_faces=21),
    "near_plane": near_scene,
    "empty": offscreen_scene,
}


def jax_planes(fv, st, ht, s, gamma_t):
    consts = PR.pack_constants(jnp.asarray(fv), jnp.asarray(st),
                               jnp.asarray(ht), n_bands=PR.bands_for(s))
    out = PR._fwd_call(consts, s, 1e-4, 1e-3, 1e-4, gamma_t, JC.NEAR,
                       JC.FAR, JC.BG_EPS, JC.EYE_OFFSET, interpret=True,
                       lane_split=PR.lane_split_for(s), compact=True)
    return {k: np.asarray(v) for k, v in out.items()}


def torch_planes(fv, st, ht, s, gamma_t, faces_per_chunk=None):
    consts = C.pack_constants(torch.tensor(fv), torch.tensor(st),
                              torch.tensor(ht), n_bands=C.bands_for(s))
    out = raster_fused_fwd_plain(consts, s, 1e-4, 1e-3, 1e-4, gamma_t,
                                 faces_per_chunk=faces_per_chunk)
    return {k: v.numpy() for k, v in out.items()}


def assert_planes_close(got, ref):
    for n in PLANES:
        assert np.isfinite(got[n]).all(), n
        if n in ("s_d", "s_t"):
            err = np.abs(got[n] - ref[n]) / np.maximum(np.abs(ref[n]), 1.0)
            assert err.max() <= S_RTOL, (n, err.max())
        else:
            np.testing.assert_allclose(got[n], ref[n], atol=ATOL[n],
                                       err_msg=n)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("gamma_t", [1e-2, 1e-4])
@pytest.mark.parametrize("s", [16, 32])
def test_plain_matches_pallas_interpret(scene, gamma_t, s):
    fv, st, ht = SCENES[scene]()
    assert_planes_close(torch_planes(fv, st, ht, s, gamma_t),
                        jax_planes(fv, st, ht, s, gamma_t))


@pytest.mark.parametrize("scene", ["random", "padded_F21", "near_plane"])
def test_render_fused_matches_dense(scene):
    """Default gammas, through the public render_fused of both packages."""
    fv, st, ht = SCENES[scene]()
    dense = render_fused_dense(jnp.asarray(fv), jnp.asarray(st),
                               jnp.asarray(ht), 16)
    out = api.render_fused(torch.tensor(fv), torch.tensor(st),
                           torch.tensor(ht), 16)
    for k, tol in (("alpha1", 2e-3), ("alpha2", 2e-3), ("depth", 2e-2),
                   ("tex", 2e-3), ("match", 2e-3)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(dense[k]),
                                   atol=tol, err_msg=k)


def test_face_chunking_is_exact():
    """Streaming carries across face chunks give the one-chunk result."""
    fv, st, ht = make_scene(seed=4, b=2, n_faces=23)
    one = torch_planes(fv, st, ht, 16, 1e-2, faces_per_chunk=64)
    for fc in (1, 5):
        many = torch_planes(fv, st, ht, 16, 1e-2, faces_per_chunk=fc)
        for n in PLANES:
            np.testing.assert_allclose(many[n], one[n], rtol=1e-5,
                                       atol=1e-6, err_msg=(fc, n))


def test_zero_faces_render_background():
    z = torch.zeros((2, 0, 3, 3))
    out = api.render_fused(z, z, z, 8)
    assert (out["alpha1"] == 0).all() and (out["alpha2"] == 0).all()
    assert (out["depth"] == 1).all() and (out["tex"] == 1).all()
    assert (out["match"] == 0).all()


def test_pack_constants_matches_jax_slots():
    """Same slot layout as pallas_raster.pack_constants (unsorted; the
    sorted and padded packing is held in tests/test_torch_raster_chunk.py)."""
    fv, st, ht = make_scene(seed=2, b=2, n_faces=16)
    ref = np.asarray(PR.pack_constants(jnp.asarray(fv), jnp.asarray(st),
                                       jnp.asarray(ht), sort_faces=False))
    got = C.pack_constants(torch.tensor(fv), torch.tensor(st),
                           torch.tensor(ht), sort_faces=False).numpy()
    assert got.shape == ref.shape == (2, 16, C.K)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_pixel_grid_matches_jax():
    """Same grid; the port multiplies by 1/S where JAX divides (one ulp)."""
    for s in (8, 13):
        xp, yp = C.pixel_grid(s)
        jx, jy = JC.pixel_grid(s)
        np.testing.assert_allclose(xp.numpy(), np.asarray(jx), rtol=0,
                                   atol=2e-7)
        np.testing.assert_allclose(yp.numpy(), np.asarray(jy), rtol=0,
                                   atol=2e-7)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs a CPU tensor, and the dispatcher never
    sends one to it: CPU tensors take the plain version."""
    fv, st, ht = make_scene()
    consts = C.pack_constants(torch.tensor(fv), torch.tensor(st),
                              torch.tensor(ht))
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.raster_fused_fwd_cuda(consts, 16, 1e-4, 1e-3, 1e-4, 1e-2)
    out = api.raster_fused_fwd(consts, 16)
    assert kernel.LAUNCHES == before
    ref = raster_fused_fwd_plain(consts, 16, 1e-4, 1e-3, 1e-4, 1e-2)
    for n in PLANES:
        assert torch.equal(out[n], ref[n]), n

