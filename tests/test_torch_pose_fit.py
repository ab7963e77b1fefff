"""The port's whole-batch RANSAC-Umeyama pose fit against the JAX package.

The RANSAC minimal samples are recomputed here from the JAX key exactly as
selfcorr_tpu/ops/umeyama.py:85-87 draws them (split(key, B), then a
categorical over each image's valid points) and handed to the port. The
scene is well conditioned (a similarity transform plus small noise and 10%
outliers), so near-tied hypothesis scores cannot flip the argmin. The pixel
budget must pick the same pixels: lax.top_k keeps lower indices first on
ties, as the port's stable descending sort does.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.eval.pose_fit import fit_poses as jax_fit_poses
from selfcorr_tpu.ops.geometry import rot6d_to_matrix
from selfcorr_tpu_torch.eval.pose_fit import fit_poses, select_points
from selfcorr_tpu_torch.ops.umeyama import draw_samples
from test_torch_threads import share_cores  # noqa: F401 (autouse)

B, H, W = 4, 32, 32
BASE_ROT = np.array([0, 0, 1, 0, -1, 0, -1, 0, 0], np.float32).reshape(3, 3)


def make_scene(seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    u = xx / (W / 2.0) - 1.0
    v = yy / (W / 2.0) - 1.0
    R = np.asarray(rot6d_to_matrix(jnp.asarray(rng.randn(B, 6))))
    pp = rng.uniform(-0.1, 0.1, (B, 2)).astype(np.float32)
    foc = rng.uniform(2.0, 3.0, (B, 2)).astype(np.float32)
    match = np.zeros((B, H, W, 3), np.float32)
    depth = np.zeros((B, H, W), np.float32)
    mask = np.zeros((B, H, W), np.float32)
    conf = np.zeros((B, H, W), np.float32)
    for b in range(B):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        m = ((u - cx) / 0.6) ** 2 + ((v - cy) / 0.5) ** 2 < 1.0
        z = 500.0 + 40.0 * rng.rand(H, W)
        q = np.stack([(u - pp[b, 0]) * z / foc[b, 0],
                      (v - pp[b, 1]) * z / foc[b, 1], z], -1)
        s = rng.uniform(90.0, 140.0)
        t = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), 520.0])
        p = ((q - t) @ R[b].T) / s + 0.002 * rng.randn(H, W, 3)
        out = rng.rand(H, W) < 0.1
        p[out] = rng.uniform(-1, 1, (out.sum(), 3))
        match[b] = p
        depth[b] = np.where(m, z, 0.0)
        mask[b] = m
        conf[b] = np.where(m & (rng.rand(H, W) > 0.1),
                           rng.uniform(0.2, 1.0, (H, W)), 0.0)
    pred_v = rng.randn(B, 42, 3).astype(np.float32)
    return dict(match=match, conf=conf, depth=depth, mask=mask, pp=pp,
                foc=foc, pred_v=pred_v)


def jax_samples(key, sc, max_points, n_iters):
    """umeyama.py:85-87 on the pixel budget fit_poses selects."""
    weight = ((sc["depth"] > 0) & (sc["mask"] > 0) & (sc["conf"] > 0))
    flat_w = jnp.asarray(weight.reshape(B, -1).astype(np.float32))
    score = flat_w * (1.0 + jnp.asarray(sc["conf"].reshape(B, -1)))
    _, idx = jax.lax.top_k(score, max_points)
    valid = jnp.take_along_axis(flat_w, idx, 1) > 0
    keys = jax.random.split(key, B)
    out = []
    for b in range(B):
        logits = jnp.where(valid[b], 0.0, -jnp.inf)
        out.append(jax.random.categorical(keys[b], logits[None, None, :],
                                          axis=-1, shape=(n_iters, 5)))
    return np.asarray(idx), np.asarray(valid), np.stack(
        [np.asarray(o) for o in out])


def test_fit_poses_matches_jax():
    sc = make_scene()
    max_points, n_iters = 512, 8
    key = jax.random.PRNGKey(3)
    ref = jax_fit_poses(key, jnp.asarray(sc["match"]), jnp.asarray(sc["conf"]),
                        jnp.asarray(sc["depth"]), jnp.asarray(sc["mask"]),
                        jnp.asarray(sc["pp"]), jnp.asarray(sc["foc"]),
                        jnp.asarray(sc["pred_v"]), jnp.asarray(BASE_ROT),
                        max_points=max_points, n_iters=n_iters)
    jidx, jvalid, samples = jax_samples(key, sc, max_points, n_iters)

    t = {k: torch.tensor(v) for k, v in sc.items()}
    idx, valid = select_points(t["conf"], t["depth"], t["mask"], max_points)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(valid.numpy(), jvalid)

    got = fit_poses(t["match"], t["conf"], t["depth"], t["mask"], t["pp"],
                    t["foc"], t["pred_v"], torch.tensor(BASE_ROT),
                    max_points=max_points, n_iters=n_iters,
                    sample_idx=torch.tensor(samples))
    assert np.asarray(ref["ok"]).all()
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(ref["ok"]))
    for k in ("bbox9", "verts", "rotation", "translation", "scale_fit",
              "size"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-3, rtol=0, err_msg=k)


def test_fit_poses_fallback_pose():
    """Too few valid pixels: identity R, t = 0.5 m, scale 0.1."""
    sc = make_scene(seed=1)
    sc["mask"][:] = 0.0
    t = {k: torch.tensor(v) for k, v in sc.items()}
    got = fit_poses(t["match"], t["conf"], t["depth"], t["mask"], t["pp"],
                    t["foc"], t["pred_v"], torch.tensor(BASE_ROT),
                    max_points=64, n_iters=4,
                    generator=torch.Generator().manual_seed(0))
    assert not got["ok"].any()
    np.testing.assert_allclose(
        got["rotation"].numpy(), np.broadcast_to(BASE_ROT, (B, 3, 3)))
    np.testing.assert_allclose(got["translation"].numpy()[:, 0],
                               np.tile([0.0, 0.0, 0.5], (B, 1)), atol=1e-6)
    np.testing.assert_allclose(got["scale_fit"].numpy(), 0.1, atol=1e-7)


def test_drawn_samples_are_valid_points():
    valid = torch.rand(3, 50, generator=torch.Generator().manual_seed(1)) > 0.6
    idx = draw_samples(valid, 20, 5, torch.Generator().manual_seed(2))
    assert idx.shape == (3, 20, 5)
    assert torch.gather(valid, 1, idx.reshape(3, -1)).all()


def stable_sort_draw(valid, u):
    """The draw as a stable sort of ~valid on the host gives it: the k-th
    point of that order, k = min(int(u * count), count - 1)."""
    b = valid.shape[0]
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    count = valid.sum(-1).clamp(min=1)[:, None, None]
    k = (u * count).long().minimum(count - 1)
    return torch.gather(order, 1, k.reshape(b, -1)).reshape(u.shape)


N_POINTS = 257
MASKS = {
    "empty": torch.zeros(N_POINTS, dtype=torch.bool),
    "full": torch.ones(N_POINTS, dtype=torch.bool),
    "prefix": torch.arange(N_POINTS) < 100,
    "scattered": torch.rand(N_POINTS, generator=torch.Generator()
                            .manual_seed(3)) > 0.7,
    "single": torch.arange(N_POINTS) == 201,
}


@pytest.mark.parametrize("mask", list(MASKS))
def test_draw_equals_the_stable_sort_draw(mask):
    """Each row's draws are the stable sort's bit for bit, the row beside
    rows of the other kinds, with uniforms at 0 and just below 1."""
    valid = torch.stack([MASKS[mask]] + [MASKS[m] for m in MASKS
                                         if m != mask])
    u = torch.rand((len(MASKS), 40, 5),
                   generator=torch.Generator().manual_seed(4))
    u[:, 0, 0], u[:, 0, 1] = 0.0, 1.0 - 2.0 ** -24
    got = draw_samples(valid, 40, 5, u=u)
    assert got.dtype == torch.int64 and got.shape == (len(MASKS), 40, 5)
    assert torch.equal(got, stable_sort_draw(valid, u))
    if mask == "empty":
        assert bool((got[0] == 0).all())


def test_fit_poses_reads_nothing_back_on_the_host():
    """The whole fit runs on inputs on the meta device, which hold no
    values, from uniforms made on the host: no step of it copies a device
    value to the host, so on a card nothing in it waits for the card."""
    meta = torch.device("meta")
    got = fit_poses(torch.empty((B, H, W, 3), device=meta),
                    *(torch.empty((B, H, W), device=meta) for _ in range(3)),
                    torch.empty((B, 2), device=meta),
                    torch.empty((B, 2), device=meta),
                    torch.empty((B, 42, 3), device=meta),
                    torch.empty((3, 3), device=meta), max_points=64,
                    n_iters=4, sample_u=torch.rand((B, 4, 5)))
    assert all(v.device == meta for v in got.values())
    assert got["bbox9"].shape == (B, 9, 3) and got["ok"].shape == (B,)
