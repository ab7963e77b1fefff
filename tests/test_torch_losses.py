"""The port's losses, image and mesh ops, and cycle losses against the JAX
package, on the same numpy-seeded inputs and the same draws.

Tolerances: 1e-5 relative (1e-6 absolute) where both sides run the same
float32 operations; the rotation cycle loss, whose matmuls and softmaxes sum
in another order, 1e-4; the DINO cycle loss 2e-3 (measured 3.2e-4): its
pooled logits carry -1e5 times a bilinearly resized off-mask fraction, so
one ulp of that fraction (the two packages resize with different
arithmetic) moves a logit by ~6e-3 before the x10 temperature.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.losses import match_losses as JML
from selfcorr_tpu.losses import regularizers as JR
from selfcorr_tpu.losses import render_losses as JRL
from selfcorr_tpu.models import correspondence as JC
from selfcorr_tpu.ops import image_ops as JI
from selfcorr_tpu.ops import knn as JK
from selfcorr_tpu.ops import mesh_ops as JMO
from selfcorr_tpu.ops.geometry import symmetry_rotations
from selfcorr_tpu_torch import losses as L
from selfcorr_tpu_torch.models import correspondence as corr
from selfcorr_tpu_torch.models.resnet import BatchNorm, frozen_stats
from selfcorr_tpu_torch.ops import image_ops as I
from selfcorr_tpu_torch.ops import knn, mesh_ops as M

RNG = np.random.RandomState(0)


def t(x):
    return torch.tensor(np.asarray(x))


def close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(ref), rtol=rtol, atol=atol)


def maps(b=3, s=32, seed=0):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(b, s, s) > 0.4).astype(np.float32)
    return dict(
        mask=mask, pred=rng.rand(b, s, s).astype(np.float32),
        img=rng.rand(b, s, s, 3).astype(np.float32),
        tex=rng.rand(b, s, s, 3).astype(np.float32),
        depth=(mask * (4.0 + rng.rand(b, s, s))).astype(np.float32),
        occ=(rng.rand(b, s, s) > 0.8).astype(np.float32))


def mesh(seed=0, b=2):
    verts, faces = M.icosphere(1)
    rng = np.random.RandomState(seed)
    v = (verts[None] * (1 + 0.2 * rng.rand(b, 1, 3))
         + 0.05 * rng.randn(b, *verts.shape)).astype(np.float32)
    return v, faces.astype(np.int64)


@pytest.mark.parametrize("with_occ", [False, True])
def test_render_losses(with_occ):
    m = maps()
    occ = m["occ"] if with_occ else None
    close(L.mask_pyramid_loss(t(m["mask"]), t(m["pred"]),
                              None if occ is None else t(occ)),
          JRL.mask_pyramid_loss(m["mask"], m["pred"], occ))
    close(L.texture_loss(t(m["img"]), t(m["mask"]), t(m["tex"]), t(m["pred"]),
                         None if occ is None else t(occ)),
          JRL.texture_loss(m["img"], m["mask"], m["tex"], m["pred"], occ))
    got, gdiff = L.depth_loss(t(m["depth"]), t(m["depth"] * 0.9 + 0.2),
                              t(m["pred"]), t(m["mask"]))
    ref, rdiff = JRL.depth_loss(m["depth"], m["depth"] * 0.9 + 0.2,
                                m["pred"], m["mask"])
    close(got, ref)
    close(gdiff, rdiff)


def test_depth_loss_chamfer_with_injected_draws():
    m = maps(b=2, s=16)
    v, faces = mesh()
    rng = np.random.RandomState(3)
    rot = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(2)]
                   ).astype(np.float32)
    trans = np.array([[[0.1, -0.1, 5.0]], [[0.0, 0.2, 6.0]]], np.float32)
    pp = np.zeros((2, 2), np.float32)
    foc = np.full((2, 2), 2.0, np.float32)
    key = jax.random.PRNGKey(4)
    ref, rdiff = JRL.depth_loss_chamfer(
        key, jnp.asarray(v), jnp.asarray(faces), m["depth"], m["pred"] + 4.5,
        m["mask"], m["mask"], pp, foc, rot, trans, n_pts=300)
    kf, kb = jax.random.split(key)
    u = t(jax.random.uniform(kf, (2, 300, 1)))
    ub = t(jax.random.uniform(kb, (2, 300, 2)))
    got, gdiff = L.depth_loss_chamfer(
        t(v), torch.tensor(faces), t(m["depth"]), t(m["pred"] + 4.5),
        t(m["mask"]), t(m["mask"]), t(pp), t(foc), t(rot), t(trans),
        n_pts=300, u=u, ub=ub)
    close(got, ref, rtol=1e-4)
    close(gdiff, rdiff)


def test_match_losses_and_pairing():
    rng = np.random.RandomState(1)
    m = maps(b=4)
    match = rng.rand(4, 32, 32, 3).astype(np.float32)
    close(L.match_loss(t(match), t(m["tex"]), t(m["pred"]), t(m["mask"])),
          JML.match_loss(match, m["tex"], m["pred"], m["mask"]))
    im = rng.rand(4, 42, 2).astype(np.float32)
    img = rng.rand(4, 42, 2).astype(np.float32)
    dw = rng.rand(4, 42).astype(np.float32)
    close(L.imatch_loss(t(im), t(img), t(dw)), JML.imatch_loss(im, img, dw))
    x = rng.rand(8, 5, 3).astype(np.float32)
    for name in ("frame", "instance", "both"):
        for g, r in zip(L.DIVIDE_FNS[name](t(x), 2, 4),
                        JML.DIVIDE_FNS[name](jnp.asarray(x), 2, 4)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_regularizers():
    v, faces = mesh()
    from selfcorr_tpu.ops.mesh_ops import laplacian_matrix, flatten_quads
    lap = laplacian_matrix(v.shape[1], faces)
    close(L.laplacian_loss(t(v), t(lap)), JR.laplacian_loss(v, lap))
    quads = flatten_quads(faces)
    close(L.flatten_loss(t(v), tuple(torch.tensor(q).long() for q in quads)),
          JR.flatten_loss(jnp.asarray(v), tuple(jnp.asarray(q)
                                                for q in quads)))
    tr = np.array([[[0.0, 0.0, 0.5]], [[0.0, 0.0, 3.0]]], np.float32)
    close(L.pullfar_loss(t(tr)), JR.pullfar_loss(tr))
    mv = v[:1].repeat(2, 0) * 0.7
    close(L.deform_loss(t(v), t(mv)), JR.deform_loss(v, mv))
    rng = np.random.RandomState(2)
    r1 = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(4)])
    r2 = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(4)])
    close(L.camera_loss(t(r1.astype(np.float32)), t(r2.astype(np.float32))),
          JR.camera_loss(r1.astype(np.float32), r2.astype(np.float32)),
          rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("symmetry_idx", [0, 1])
def test_symmetry_loss_and_surface_samples_with_jax_draws(symmetry_idx):
    v, faces = mesh(seed=symmetry_idx)
    key = jax.random.PRNGKey(7)
    kf, kb = jax.random.split(key)
    u = t(jax.random.uniform(kf, (2, 256, 1)))
    ub = t(jax.random.uniform(kb, (2, 256, 2)))
    ref_pts = JMO.sample_surface(key, jnp.asarray(v), jnp.asarray(faces), 256)
    got_pts = M.sample_surface(t(v), torch.tensor(faces), 256, u=u, ub=ub)
    close(got_pts, ref_pts, rtol=1e-5, atol=1e-6)
    rots = symmetry_rotations(symmetry_idx)
    close(L.symmetry_loss(t(v), torch.tensor(faces), t(rots), 256, u=u,
                          ub=ub),
          JR.symmetry_loss(key, jnp.asarray(v), jnp.asarray(faces),
                           jnp.asarray(rots), 256), rtol=1e-5)


def test_symmetry_loss_does_not_depend_on_the_thread_count():
    """ROADMAP C.13: the symmetry loss and its vertex gradient are bit for
    bit alike at 1 CPU thread and at all of them, at the training path's
    sample count. (The train step's CPU forward upstream of it is not: its
    convolutions change with the thread count, and the face pick turns that
    into a loss difference; tests/split_c13.py prints it.)"""
    v, faces = mesh(seed=3)
    u, ub = M.surface_draws(torch.Generator().manual_seed(3), 2, 10000)
    rots = t(symmetry_rotations(0))
    threads = torch.get_num_threads()
    got = []
    for n in (1, max(threads, 2)):
        torch.set_num_threads(n)
        try:
            vt = t(v).requires_grad_(True)
            loss = L.symmetry_loss(vt, torch.tensor(faces), rots, 10000, u=u,
                                   ub=ub)
            loss.backward()
            got.append((loss.detach(), vt.grad))
        finally:
            torch.set_num_threads(threads)
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


def test_zero_area_faces_are_never_sampled():
    v, faces = mesh()
    faces = np.concatenate([faces, [[0, 0, 0], [1, 1, 1]]]).astype(np.int64)
    areas = M.face_areas(t(v), torch.tensor(faces))
    assert (areas[:, -2:] == 0).all()
    g = torch.Generator().manual_seed(0)
    u, ub = M.surface_draws(g, 2, 4096)
    cum = torch.cumsum(areas, -1)
    idx = torch.searchsorted(cum, (u * cum[:, -1:, None])[..., 0],
                             right=True)
    assert not bool((idx >= faces.shape[0] - 2).any())
    pts = M.sample_surface(t(v), torch.tensor(faces), 4096, u=u, ub=ub)
    assert torch.isfinite(pts).all()


def test_min_sq_dist_and_chamfer():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 50, 3).astype(np.float32)
    y = rng.randn(2, 80, 3).astype(np.float32)
    valid = (rng.rand(2, 80) > 0.3).astype(np.float32)
    close(knn.min_sq_dist(t(x), t(y), t(valid)), JK.min_sq_dist(x, y, valid))
    close(knn.chamfer_single_way(t(x), t(y)), JK.chamfer_single_way(x, y))
    xv = (rng.rand(2, 50) > 0.5).astype(np.float32)
    close(knn.chamfer_single_way(t(x), t(y), x_valid=t(xv),
                                 batch_reduction=None),
          JK.chamfer_single_way(x, y, x_valid=xv, batch_reduction=None))


@pytest.mark.parametrize("angle", [10.0, 100.0, 190.0, 280.0, 90.0, 44.0])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_rotate_fast_every_quarter_turn(angle, mode):
    img = RNG.rand(2, 16, 16, 3).astype(np.float32)
    close(I.rotate_fast(t(img), torch.tensor(angle), mode=mode),
          JI.rotate_fast(jnp.asarray(img), jnp.asarray(angle), mode=mode),
          rtol=1e-5, atol=1e-5)


def test_area_resampling():
    x = RNG.rand(2, 16, 16, 3).astype(np.float32)
    for f in (1, 2, 4):
        close(I.downsample_area(t(x), f), JI.downsample_area(x, f))
        close(I.upsample_repeat(t(x), f), JI.upsample_repeat(x, f))


def _encoder(weights):
    """A fixed encoder for both packages: 4x4 average pooling to the 8x8
    feature grid, a linear map to 16 channels, L2-normalized."""
    def enc_t(x):
        b = x.shape[0]
        x = x.reshape(b, 8, 4, 8, 4, 3).mean(dim=(2, 4)).reshape(b, 64, 3)
        f = x @ torch.tensor(weights)
        return f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    def enc_j(x):
        b = x.shape[0]
        x = x.reshape(b, 8, 4, 8, 4, 3).mean(axis=(2, 4)).reshape(b, 64, 3)
        f = x @ weights
        return f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True),
                               1e-12)
    return enc_t, enc_j


def test_rotation_cycle_loss_with_jax_angle():
    rng = np.random.RandomState(8)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    mask = np.zeros((2, 32, 32), np.float32)
    mask[:, 6:26, 8:28] = 1.0
    enc_t, enc_j = _encoder(rng.randn(3, 16).astype(np.float32))
    key = jax.random.PRNGKey(9)
    angle = float(jax.random.uniform(key, (), minval=0.0, maxval=360.0))
    grid_j = JC.make_meshgrid(8, 8)
    ref = JC.rotation_cycle_loss(key, jnp.asarray(img), jnp.asarray(mask),
                                 enc_j(jnp.asarray(img)), enc_j, grid_j, 10.0,
                                 8, 8)
    got = corr.rotation_cycle_loss(torch.tensor(angle), t(img), t(mask),
                                   enc_t(t(img)), enc_t,
                                   corr.make_meshgrid(8, 8), 10.0, 8, 8)
    for g, r in zip(got, ref):
        close(g, r, rtol=1e-4, atol=1e-5)


def test_dino_pair_match_keeps_lower_index_on_ties():
    """Cycle-consistent matches tie at distance 0; lax.top_k keeps the lower
    index first, and so must the port."""
    rng = np.random.RandomState(10)
    feat = rng.randn(2, 16, 8).astype(np.float32)
    feat[:, 8:] = feat[:, :8]              # duplicate rows: many ties
    mask = np.ones((2, 16, 16), np.float32)
    mask[1, :4] = 0.0
    grid = np.broadcast_to(np.asarray(JC.make_meshgrid(4, 4))[None],
                           (2, 16, 2)).copy()
    ref = JC.dino_pair_match(jnp.asarray(feat), jnp.asarray(feat[:, ::-1]),
                             jnp.asarray(mask), jnp.asarray(mask),
                             jnp.asarray(grid), 10)
    got = corr.dino_pair_match(t(feat), t(feat[:, ::-1].copy()), t(mask),
                               t(mask), t(grid), 10)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _cycle_inputs(seed=11, b=2, hf=8, n=42, c=16, q=16):
    rng = np.random.RandomState(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
    masks = (rng.rand(2, b, 32, 32) > 0.3).astype(np.float32)
    return dict(
        feat=(rng.randn(b, q, 24).astype(np.float32),
              rng.randn(b, q, 24).astype(np.float32)),
        mask=(masks[0], masks[1]),
        dw=(rng.rand(b, n).astype(np.float32),
            rng.rand(b, n).astype(np.float32)),
        imgf=(unit(rng.randn(b, hf * hf, c)), unit(rng.randn(b, hf * hf, c))),
        meshf=(unit(rng.randn(b, n, c)), unit(rng.randn(b, n, c))))


def test_dino_cycle_loss_against_jax_and_its_dense_oracle():
    d = _cycle_inputs()
    grid_t, grid_j = corr.make_meshgrid(8, 8), JC.make_meshgrid(8, 8)
    args = (10.0, 10.0, 8, 8, 6)
    pair_t = lambda k: tuple(t(x) for x in d[k])  # noqa: E731
    pair_j = lambda k: tuple(jnp.asarray(x) for x in d[k])  # noqa: E731
    got, gvis = corr.dino_cycle_loss(
        pair_t("feat"), pair_t("mask"), pair_t("dw"), pair_t("imgf"),
        pair_t("meshf"), grid_t, *args)
    ref, rvis = JC.dino_cycle_loss(
        pair_j("feat"), pair_j("mask"), pair_j("dw"), pair_j("imgf"),
        pair_j("meshf"), grid_j, *args)
    close(got, ref, rtol=2e-3, atol=1e-6)
    for k in ("pts_src", "pts_tgt", "mask"):
        np.testing.assert_array_equal(gvis[k].numpy(), np.asarray(rvis[k]))
    close(gvis["match"], rvis["match"], rtol=2e-3, atol=2e-3)
    # the port's own dense oracle, on the full-res cost volumes
    masks_down = [I.resize_nearest(m[..., None], (8, 8)).reshape(2, -1) > 0
                  for m in pair_t("mask")]
    pcs = [corr.masked_cost_volume(f, mf, md) for f, mf, md in
           zip(pair_t("imgf"), pair_t("meshf"), masks_down)]
    dense, dvis = corr.dino_cycle_loss_dense(
        pair_t("feat"), pair_t("mask"), pair_t("dw"), tuple(pcs), grid_t,
        *args)
    # the JAX package's own factored-vs-dense bound on the loss
    # (tests/test_dino_cycle.py:71-76); a match row whose softmax mass lands
    # on dw-masked vertices divides by ~1e-5 and amplifies reassociation
    # noise (measured 3.6e-3 on such rows here), so the matches get 1e-2
    close(got, dense, rtol=1e-3, atol=2e-5)
    close(gvis["match"], dvis["match"], rtol=2e-2, atol=1e-2)


def test_batchnorm_running_variance_is_biased():
    """flax nn.BatchNorm moves the running variance toward the biased batch
    variance; torch's BatchNorm2d uses the unbiased one (4/3 larger at
    n = 4, the 1x1 layer4 of a 32 x 32 input at batch 4)."""
    import flax.linen as nn
    x = RNG.randn(4, 1, 1, 8).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    y_ref, upd = bn.apply(v, x, mutable=["batch_stats"])
    m = BatchNorm(8).train()
    y = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(y, y_ref, rtol=1e-4, atol=1e-5)
    close(m.running_mean, upd["batch_stats"]["mean"])
    close(m.running_var, upd["batch_stats"]["var"])


def test_frozen_stats_normalizes_without_moving_the_running_stats():
    x = t(RNG.randn(4, 8, 5, 5).astype(np.float32))
    m = BatchNorm(8).train()
    y_train = m(x)
    mean, var = m.running_mean.clone(), m.running_var.clone()
    with frozen_stats(m):
        y = m(x)
    assert torch.equal(m.running_mean, mean)
    assert torch.equal(m.running_var, var)
    torch.testing.assert_close(y, y_train)
    assert m.update_stats
