"""The port's DINO ViT-S/8 trunk and attention against the JAX package.

Weights are the flax DinoViTS8 initialization carried by
from_jax_dino_params; the input is a numpy-seeded 32 x 32 batch (17 tokens,
a ragged count for the key tiles).

* The f32 trunk (attn_bf16 off) equals flax DinoViTS8 within 1e-4.
* With attn_bf16 the port runs the flash arithmetic of the TPU library
  kernel (plain version on the CPU). Off the TPU the JAX package has no flash
  path (vit.py:23-28); its closest oracle is the bf16 XLA path, which
  differs from the flash arithmetic in where it rounds. Measured at this
  size, as fractions of the features' largest entry: port vs JAX bf16
  3.6e-3 (mean 3.9e-4), port vs the f32 trunk 3.9e-3, the JAX bf16 trunk vs
  its f32 trunk 3.9e-3, the port's f32 trunk vs the JAX bf16 trunk 3.9e-3
  (mean 4.6e-4): mostly the bf16 rounding of the returned keys, which both
  bf16 trunks share. The bound set is 4e-3, which the f32 trunk also meets;
  what shows that the flash arithmetic is the JAX bf16 path's is that the
  port's bf16 trunk lies nearer the JAX bf16 trunk, in max and in mean, than
  the port's f32 trunk does.
* The attention's plain flash version against the f32 softmax at ragged T,
  within the bf16 rounding of p and of the output, on both sides of the key
  tile; the plain version's key tile is the kernel's.
"""
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.models.vit import DinoViTS8 as JaxDino
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.ops import attention as A
from selfcorr_tpu_torch.utils import weight_convert as W
from test_torch_threads import share_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def trunks():
    img = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    params = jax.jit(JaxDino().init)(jax.random.PRNGKey(0),
                                     jnp.asarray(img))["params"]
    out = {}
    for bf16 in (False, True):
        out[bf16] = np.asarray(jax.jit(JaxDino(attn_bf16=bf16).apply)(
            {"params": params}, jnp.asarray(img)))
    sd = W.from_jax_dino_params(jax.tree_util.tree_map(np.asarray, params))
    return img, sd, out


def port_features(img, sd, attn_bf16):
    model = DinoViTS8(img_size=32, attn_bf16=attn_bf16)
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.tensor(img)).numpy()


def test_f32_trunk_matches_flax(trunks):
    img, sd, ref = trunks
    got = port_features(img, sd, False)
    assert got.shape == ref[False].shape == (2, 4, 4, 384)
    np.testing.assert_allclose(got, ref[False], atol=1e-4, rtol=0)


def test_bf16_attention_trunk_against_both_oracles(trunks):
    img, sd, ref = trunks
    got = port_features(img, sd, True)
    f32 = port_features(img, sd, False)
    scale = np.abs(ref[False]).max()
    for oracle in (ref[True], ref[False]):
        assert np.abs(got - oracle).max() <= 4e-3 * scale
    for stat in (np.max, np.mean):
        assert stat(np.abs(got - ref[True])) < stat(np.abs(f32 - ref[True]))


def test_checkpoint_names(trunks):
    _, sd, _ = trunks
    assert {"patch_embed.proj.weight", "cls_token", "pos_embed",
            "blocks.9.attn.qkv.weight", "blocks.0.mlp.fc2.bias",
            "blocks.3.norm2.weight"} <= set(sd)
    assert not any(k.startswith("blocks.10.") for k in sd)


@pytest.mark.parametrize("t", [1, 17, 65, 130, A.BLOCK_K - 1, A.BLOCK_K,
                               A.BLOCK_K + 1, 2 * A.BLOCK_K + 1])
def test_plain_flash_matches_softmax(t):
    """Flash arithmetic vs the materialized f32 softmax on the same bf16
    inputs: p rounds to bf16 (2^-9 relative, moving the output by at most
    2^-9 max|v|) and the output rounds to bf16 (2^-9 of its value)."""
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn(2, 3, t, 64, generator=g).bfloat16()
               for _ in range(3))
    got = A.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ref = A.attention_f32_plain(q.float(), k.float(), v.float())
    lim = 2.0 ** -8 * ref.abs() + 2.0 ** -8 * float(v.float().abs().max())
    assert bool(((got.float() - ref).abs() <= lim).all())


def test_plain_key_tile_is_the_kernels():
    """flash_attention_plain takes its online-softmax steps over the
    kernel's key tiles: BLOCK_K equals BK in csrc/flash_attn.cu."""
    with open(A.SOURCE) as f:
        src = f.read()
    bk = re.search(r"constexpr int BK = (\d+);", src)
    assert bk and int(bk.group(1)) == A.BLOCK_K
    assert os.path.basename(A.SOURCE) == "flash_attn.cu"


def test_routes():
    """CPU tensors take the plain versions and count no launch; the kernel
    wrapper refuses CPU tensors."""
    q = torch.randn(1, 1, 5, 64)
    before = dict(A.LAUNCHES)
    torch.testing.assert_close(A.attention(q, q, q),
                               A.attention_f32_plain(q, q, q))
    qb = q.bfloat16()
    assert torch.equal(A.attention(qb, qb, qb),
                       A.flash_attention_plain(qb, qb, qb))
    assert A.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_attention_cuda(qb, qb, qb)


# --- the bfloat16 trunk at rest (--dino_bf16) ------------------------------

@pytest.fixture(scope="module")
def params(trunks):
    """The trunks fixture's flax parameters (the same key and input)."""
    img = trunks[0]
    return jax.jit(JaxDino().init)(jax.random.PRNGKey(0),
                                   jnp.asarray(img))["params"]


def bf16_params(params):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)


def port_trunk(sd, feature_layer=9):
    """The port's trunk on the weights `sd`, cast to bfloat16 (attn_bf16
    off)."""
    keep = {k: v for k, v in sd.items() if not k.startswith("blocks.") or
            int(k.split(".")[1]) <= feature_layer}
    model = DinoViTS8(img_size=32, feature_layer=feature_layer,
                      attn_bf16=False)
    model.load_state_dict(keep)
    return model.to(torch.bfloat16)


def test_bf16_trunk_rounds_where_flax_does(trunks, params):
    """The trunk up to block 0's keys (patch embedding, position
    embedding, LayerNorm, qkv) in bfloat16 against flax's bf16 parameters
    on the bf16 image: the products rounded before their bias as flax
    rounds them; an entry may differ by one bf16 ulp where the two
    products' f32 sums round apart (0.008% measured)."""
    img, sd, _ = trunks
    want = np.asarray(JaxDino(feature_layer=0).apply(
        {"params": bf16_params(params)},
        jnp.asarray(img).astype(jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = port_trunk(sd, feature_layer=0)(
            torch.tensor(img).bfloat16()).float().numpy()
    differ = got != want
    assert differ.mean() <= 1e-3
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want))[differ].all()


def test_bf16_trunk_against_jax_bf16_trunk(trunks, params, monkeypatch):
    """The 10 blocks in bfloat16 against flax's on bf16 parameters and the
    bf16 image, attn_bf16 off. q, k and v are bf16 all the same, so every
    block's attention takes the flash route (flash_attention_plain on the
    CPU, kernel B3 on the card); the JAX package's CPU trunk has no flash
    path and runs XLA's bf16 attention, which rounds elsewhere (p
    normalized before its bf16 rounding). Measured, as fractions of the
    features' largest entry: max 8.0e-3, mean 1.6e-3 (the JAX bf16 trunk
    against its f32 trunk: 1.07e-2, 1.6e-3). Bounds 1.2e-2 and 2.5e-3."""
    img, sd, ref = trunks
    want = np.asarray(jax.jit(JaxDino().apply)(
        {"params": bf16_params(params)},
        jnp.asarray(img).astype(jnp.bfloat16)).astype(jnp.float32))
    calls = []
    plain = A.flash_attention_plain

    def spy(q, k, v):
        calls.append(q.dtype)
        return plain(q, k, v)
    monkeypatch.setattr(A, "flash_attention_plain", spy)
    model = port_trunk(sd)
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        out = model(torch.tensor(img).bfloat16())
    assert out.dtype == torch.bfloat16 and calls == [torch.bfloat16] * 9
    got = out.float().numpy()
    scale = np.abs(ref[False]).max()
    assert np.abs(got - want).max() <= 1.2e-2 * scale
    assert np.abs(got - want).mean() <= 2.5e-3 * scale


def test_vis_trunk_computes_in_f32_from_bf16_weights(trunks, params):
    """forward_vis under --dino_bf16 (the Trainer's _log_images): flax
    applies the bf16 parameters to the f32 image, promoting every layer to
    f32, so the panels' trunk is the f32 trunk on bf16-rounded weights. The
    port's f32 copy of the bf16 trunk against it, within 1e-5 of the
    features' largest entry (9e-7 measured); the f32 trunk on the
    unrounded weights lies further away."""
    img, sd, ref = trunks
    want = np.asarray(jax.jit(JaxDino().apply)(
        {"params": bf16_params(params)}, jnp.asarray(img)))
    assert want.dtype == np.float32
    vis = port_trunk(sd).float()
    with torch.no_grad():
        got = vis(torch.tensor(img)).numpy()
    scale = np.abs(ref[False]).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(ref[False] - want).max() > 1e-3 * scale
