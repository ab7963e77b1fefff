"""The port's geometry, mesh, image, correspondence, crop and config code
against the JAX package, on the same numpy inputs.

Float tolerances are 1e-5 absolute unless stated: both sides compute in
float32 on the CPU and differ in operation order only. Index-valued results
(nearest resizes, mesh topology, crops' nearest planes) must be exact.
"""
import io
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu import configs as JCFG
from selfcorr_tpu.data import crops as JCROP
from selfcorr_tpu.models import correspondence as JCORR
from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu.ops import geometry as JG
from selfcorr_tpu.ops import image_ops as JI
from selfcorr_tpu.ops import mesh_ops as JMO
from selfcorr_tpu.ops import umeyama as JU
from selfcorr_tpu_torch import configs as CFG
from selfcorr_tpu_torch.data import crops as CROP
from selfcorr_tpu_torch.data.synthetic import SyntheticVideos
from selfcorr_tpu_torch.models import correspondence as CORR
from selfcorr_tpu_torch.models import meshnet as M
from selfcorr_tpu_torch.ops import geometry as G
from selfcorr_tpu_torch.ops import image_ops as I
from selfcorr_tpu_torch.ops import mesh_ops as MO
from selfcorr_tpu_torch.ops import umeyama as U
from selfcorr_tpu_torch.utils import imageio
from test_torch_threads import share_cores  # noqa: F401 (autouse)

LAPTOP = "config/wild6d/laptop.txt"


def close(a, b, atol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def jax_jitter_factors(key):
    """The four factors selfcorr_tpu.ops.image_ops.color_jitter draws."""
    kb, kc, ks, kh = jax.random.split(key, 4)
    return np.array([
        jax.random.uniform(kb, (), minval=0.8, maxval=1.2),
        jax.random.uniform(kc, (), minval=0.8, maxval=1.2),
        jax.random.uniform(ks, (), minval=0.8, maxval=1.2),
        jax.random.uniform(kh, (), minval=-0.05, maxval=0.05)], np.float32)


def test_color_jitter_with_injected_factors():
    img = np.random.RandomState(0).rand(3, 8, 9, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = JI.color_jitter(key, jnp.asarray(img))
    got = I.color_jitter(torch.tensor(img),
                         torch.tensor(jax_jitter_factors(key)))
    close(got, ref)
    g = torch.Generator().manual_seed(0)
    f = I.jitter_factors(g)
    assert f.shape == (4,) and (f[:3] >= 0.8).all() and (f[:3] <= 1.2).all()
    assert abs(float(f[3])) <= 0.05
    with pytest.raises(ValueError):
        I.color_jitter(torch.tensor(img))


def test_grid_sample_and_resizes():
    rng = np.random.RandomState(1)
    img = rng.rand(2, 7, 9, 3).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (2, 30, 2)).astype(np.float32)
    close(I.grid_sample(torch.tensor(img), torch.tensor(coords)),
          JI.grid_sample(jnp.asarray(img), jnp.asarray(coords)))
    feat = rng.rand(2, 8, 8, 5).astype(np.float32)
    for hw in [(16, 16), (4, 4), (32, 24), (5, 3)]:
        close(I.resize_bilinear(torch.tensor(feat), hw),
              JI.resize_bilinear(jnp.asarray(feat), hw))
        np.testing.assert_array_equal(
            I.resize_nearest(torch.tensor(feat), hw).numpy(),
            np.asarray(JI.resize_nearest(jnp.asarray(feat), hw)))


def test_geometry():
    rng = np.random.RandomState(2)
    x6 = rng.randn(5, 6).astype(np.float32)
    close(G.rot6d_to_matrix(torch.tensor(x6)),
          JG.rot6d_to_matrix(jnp.asarray(x6)))
    q = rng.randn(5, 4).astype(np.float32)
    close(G.quat_to_matrix(torch.tensor(q)), JG.quat_to_matrix(jnp.asarray(q)))
    v = rng.randn(3, 10, 3).astype(np.float32)
    R = np.asarray(JG.rot6d_to_matrix(jnp.asarray(x6[:3])))
    t = rng.randn(3, 1, 3).astype(np.float32) + np.array([0, 0, 6], np.float32)
    cam = G.rigid_transform(torch.tensor(v), torch.tensor(R), torch.tensor(t))
    close(cam, JG.rigid_transform(jnp.asarray(v), jnp.asarray(R),
                                  jnp.asarray(t)))
    pp = rng.uniform(-0.2, 0.2, (3, 2)).astype(np.float32)
    foc = rng.uniform(2, 3, (3, 2)).astype(np.float32)
    for flip in (True, False):
        close(G.project_ndc(cam, torch.tensor(pp), torch.tensor(foc), flip),
              JG.project_ndc(jnp.asarray(cam.numpy()), jnp.asarray(pp),
                             jnp.asarray(foc), flip))
    for idx in (-1, 0, 1):
        np.testing.assert_array_equal(G.symmetry_rotations(idx),
                                      JG.symmetry_rotations(idx))


def test_mesh_builders_and_constants():
    for sub in (0, 1, 2):
        v, f = MO.icosphere(sub)
        jv, jf = JMO.icosphere(sub)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_allclose(v, jv, rtol=0, atol=1e-12)
    cfg = CFG.parse_args(["--flagfile", LAPTOP])
    jcfg = JCFG.parse_args(["--flagfile", LAPTOP])
    ours = M.build_mesh_constants(cfg)
    ref = JM.build_mesh_constants(jcfg)
    assert ours.mean_v_init.shape == (592, 3)
    assert ours.faces.shape == (1176, 3)
    for name in ("mean_v_init", "faces", "symm_rots", "laplacian",
                 "base_rot"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name), err_msg=name)
    for a, b in zip(ours.flatten_quads, ref.flatten_quads):
        np.testing.assert_array_equal(a, b)
    ico = M.build_mesh_constants(CFG.Config(subdivide=1))
    assert ico.mean_v_init.shape == (42, 3) and ico.faces.shape == (80, 3)


def test_flagfiles_parse_like_the_jax_package():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cfg = CFG.parse_args(["--flagfile", LAPTOP, "--device", "cpu",
                              "--nouse_depth", "--batch_size=16", "--eval"])
    assert "ignoring" not in out.getvalue(), out.getvalue()
    jcfg = JCFG.parse_args(["--flagfile", LAPTOP, "--nouse_depth",
                            "--batch_size=16", "--eval"])
    for k, v in vars(jcfg).items():
        assert getattr(cfg, k) == v, k
    assert cfg.device == "cpu" and CFG.Config().device == "cuda"


def test_dual_softmax_match_with_confidence():
    rng = np.random.RandomState(3)
    b, hf, wf, n, c = 2, 4, 4, 12, 8
    img_feat = rng.randn(b, hf * wf, c).astype(np.float32)
    mesh_feat = rng.randn(b, n, c).astype(np.float32)
    img_feat /= np.linalg.norm(img_feat, axis=-1, keepdims=True)
    mesh_feat /= np.linalg.norm(mesh_feat, axis=-1, keepdims=True)
    mask = (rng.rand(b, 16, 16) > 0.3).astype(np.float32)
    pred_v = rng.randn(b, n, 3).astype(np.float32)
    grid = CORR.make_meshgrid(hf, wf)
    np.testing.assert_array_equal(grid.numpy(),
                                  np.asarray(JCORR.make_meshgrid(hf, wf)))
    ours = CORR.dual_softmax_match(
        torch.tensor(img_feat), torch.tensor(mesh_feat), torch.tensor(mask),
        torch.tensor(pred_v), grid, 10.0, 10.0, hf, wf, compute_conf=True)
    ref = JCORR.dual_softmax_match(
        jnp.asarray(img_feat), jnp.asarray(mesh_feat), jnp.asarray(mask),
        jnp.asarray(pred_v), jnp.asarray(grid.numpy()), 10.0, 10.0, hf, wf,
        compute_conf=True)
    for a, b_, name in zip(ours, ref, ("pointcorr", "match", "imatch",
                                       "conf")):
        close(a, b_, atol=1e-4 if name == "pointcorr" else 1e-5)


def test_umeyama_similarity():
    rng = np.random.RandomState(4)
    src = rng.randn(4, 20, 3).astype(np.float32)
    w = (rng.rand(4, 20) > 0.2).astype(np.float32)
    R = np.asarray(JG.rot6d_to_matrix(jnp.asarray(rng.randn(4, 6))))
    tgt = 2.5 * np.einsum("bnc,bcd->bnd", src, R) + rng.randn(4, 1, 3) \
        + 0.01 * rng.randn(4, 20, 3)
    tgt = tgt.astype(np.float32)
    s, Rt, t, ok = U.umeyama_similarity(torch.tensor(src), torch.tensor(tgt),
                                        torch.tensor(w))
    for i in range(4):
        js, jR, jt, jok = JU.umeyama_similarity(
            jnp.asarray(src[i]), jnp.asarray(tgt[i]), jnp.asarray(w[i]))
        close(s[i], js, atol=1e-4)
        close(Rt[i], jR, atol=1e-4)
        close(t[i], jt, atol=1e-4)
        assert bool(ok[i]) == bool(jok)


@pytest.mark.parametrize("no_stretch", [False, True])
def test_crop_frame_matches_cv2_crops(no_stretch):
    """cv2-free crops: bilinear planes within 1e-5, nearest planes exact."""
    vids = SyntheticVideos(2, 6, raw_size=96)
    for vid, fid, size in ((0, 0, 32), (1, 3, 64), (0, 5, 256)):
        img, mask, depth, foc, pp = vids.render_frame(vid, fid)
        depth = depth + np.random.RandomState(fid).rand(*depth.shape) \
            .astype(np.float32) * mask
        for scale in (np.array([1.35, 1.35]), np.array([1.9, 1.2])):
            ours = CROP.crop_frame(img, mask, depth, foc, pp, size, scale,
                                   no_stretch)
            ref = JCROP.crop_frame(img, mask, depth, foc, pp, size, scale,
                                   no_stretch)
            assert ours.keys() == ref.keys()
            np.testing.assert_allclose(ours["img"], ref["img"], rtol=0,
                                       atol=1e-5)
            for k in ("mask", "depth", "center", "length", "foc", "pp",
                      "foc_crop", "pp_crop"):
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_png_roundtrip(tmp_path):
    rng = np.random.RandomState(5)
    for shape in ((7, 5, 3), (4, 9)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / "x.png")
        imageio.write_png(path, img)
        back = imageio.read_unchanged(path)      # 3 channels in BGR order
        np.testing.assert_array_equal(back[..., ::-1] if img.ndim == 3
                                      else back, img)
    assert imageio.to_u8(np.array([-1.0, 0.5, 2.0])).tolist() == [0, 127,
                                                                  255]


def test_upload_packs_host_tensors_into_one_buffer_per_dtype():
    """utils/device.py upload: every host tensor comes back equal, in its
    shape and dtype, as a view of one flat buffer per dtype, in order."""
    from selfcorr_tpu_torch.utils.device import upload
    gen = torch.Generator().manual_seed(0)
    host = [torch.rand((2, 3, 1), generator=gen), torch.arange(5),
            torch.rand((), generator=gen), torch.rand((4,), generator=gen),
            torch.arange(3).reshape(3, 1)]
    got = upload(host, "cpu")
    for h, g in zip(host, got):
        assert g.shape == h.shape and g.dtype == h.dtype
        assert torch.equal(g, h)
    floats = {g.untyped_storage().data_ptr() for g in got
              if g.dtype == torch.float32}
    longs = {g.untyped_storage().data_ptr() for g in got
             if g.dtype == torch.int64}
    assert len(floats) == 1 and len(longs) == 1 and floats != longs
    assert [g.storage_offset() for g in got] == [0, 0, 6, 7, 5]
    host[0].zero_()              # the caller's tensors are free at once
    assert torch.equal(got[3], host[3]) and float(got[0].abs().sum()) > 0
