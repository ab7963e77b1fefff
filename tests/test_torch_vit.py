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
