"""The port's nets against the flax modules of the JAX package.

Each flax module is initialized from a JAX key (BatchNorm running statistics
randomized so eval mode is not an identity), its parameters are carried into
the port's nn.Module by utils/weight_convert.py, and both run eval mode on
the same numpy inputs. Tolerance 1e-4 absolute: both sides are float32 on
the CPU, so the differences are summation order only.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from selfcorr_tpu.configs import Config as JConfig
from selfcorr_tpu.models import heads as JH
from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu.models import pointnet as JP
from selfcorr_tpu.models import resnet as JR
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.models import heads, meshnet, pointnet, resnet
from selfcorr_tpu_torch.utils import weight_convert as W
from test_torch_threads import share_cores  # noqa: F401 (autouse)

ATOL = 1e-4
SMALL = dict(img_size=32, corr_h=8, corr_w=8, n_corr_feat=16, codedim=8,
             depth_offset=5.0, rotation_offset=(0.2, 0.0, 0.0, 0.0, -0.2, 0.2))


def randomize_stats(stats, seed=0):
    rng = np.random.RandomState(seed)

    def f(path, x):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        return jnp.asarray(rng.rand(*x.shape).astype(np.float32) + 0.5)
    return jax.tree_util.tree_map_with_path(f, stats)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def t2n(x):
    return x.detach().numpy()


def test_resnet18_and_fpn():
    rng = np.random.RandomState(0)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    jnet = JR.ResNet18()
    v = jax.jit(lambda k: jnet.init(k, jnp.asarray(img), False))(
        jax.random.PRNGKey(0))
    stats = randomize_stats(v["batch_stats"])
    jfeats = jax.jit(lambda p, s: jnet.apply(
        {"params": p, "batch_stats": s}, jnp.asarray(img), False))(
        v["params"], stats)
    net = resnet.ResNet18().eval()
    net.load_state_dict(W.resnet18_state(np_tree(v["params"]),
                                         np_tree(stats)))
    feats = net(torch.tensor(img))
    for a, b in zip(feats, jfeats):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=ATOL)

    for down in (4, 8):
        jdec = JR.FPNDecoder(out_channels=16, downsample=down)
        vd = jax.jit(lambda k: jdec.init(k, jfeats, False))(
            jax.random.PRNGKey(1))
        sd = randomize_stats(vd["batch_stats"], seed=down)
        jout = jax.jit(lambda p, s: jdec.apply(
            {"params": p, "batch_stats": s}, jfeats, False))(
            vd["params"], sd)
        dec = resnet.FPNDecoder(16, down).eval()
        dec.load_state_dict(W.fpn_state(np_tree(vd["params"]), np_tree(sd)))
        out = dec(tuple(torch.tensor(np.asarray(f)) for f in jfeats))
        np.testing.assert_allclose(t2n(out), np.asarray(jout), atol=ATOL)


def test_mesh_encoder():
    x = np.random.RandomState(1).randn(3, 42, 3).astype(np.float32)
    jm = JP.MeshEncoder(16)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    m = pointnet.MeshEncoder(16)
    m.load_state_dict(W.mesh_encoder_state(np_tree(v["params"])))
    np.testing.assert_allclose(t2n(m(torch.tensor(x))),
                               np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("use_scale", [False, True])
def test_pose_predictor(use_scale):
    feat = np.random.RandomState(2).randn(4, 512).astype(np.float32)
    kw = dict(rotation_offset=SMALL["rotation_offset"], depth_offset=5.0,
              use_scale=use_scale)
    jp = JH.PosePredictor(**kw)
    v = jp.init(jax.random.PRNGKey(3), jnp.asarray(feat))
    p = heads.PosePredictor(**kw)
    p.load_state_dict(W.pose_predictor_state(np_tree(v["params"])))
    for a, b in zip(p(torch.tensor(feat)), jp.apply(v, jnp.asarray(feat))):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=ATOL)


def test_shape_deformer():
    rng = np.random.RandomState(3)
    mean_v = rng.randn(2, 42, 3).astype(np.float32)
    code = rng.randn(2, 8).astype(np.float32)
    js = JH.ShapeDeformer(code_dim=8, deform_ratio=0.5)
    v = js.init(jax.random.PRNGKey(4), jnp.asarray(mean_v), jnp.asarray(code))
    s = heads.ShapeDeformer(code_dim=8, deform_ratio=0.5)
    s.load_state_dict(W.shape_deformer_state(np_tree(v["params"])))
    np.testing.assert_allclose(
        t2n(s(torch.tensor(mean_v), torch.tensor(code))),
        np.asarray(js.apply(v, jnp.asarray(mean_v), jnp.asarray(code))),
        atol=ATOL)
    # no_deform passes the mean shape through, with no parameters
    nd = heads.ShapeDeformer(code_dim=8, no_deform=True)
    assert not list(nd.parameters())
    assert torch.equal(nd(torch.tensor(mean_v), torch.tensor(code)),
                       torch.tensor(mean_v))


def test_networks_whole():
    """Networks (all nets + principal-point compensation), weights carried
    by from_jax_params into MeshNet under the reference's names."""
    jcfg = JConfig(subdivide=1, **SMALL)
    cfg = Config(subdivide=1, **SMALL)
    constants = meshnet.build_mesh_constants(cfg)
    rng = np.random.RandomState(4)
    b = 3
    img = rng.rand(b, 32, 32, 3).astype(np.float32)
    mean_v = np.broadcast_to(constants.mean_v_init,
                             (b,) + constants.mean_v_init.shape).copy()
    pp = rng.uniform(-0.1, 0.1, (b, 2)).astype(np.float32)
    foc = rng.uniform(2.0, 3.0, (b, 2)).astype(np.float32)

    jnet = JM.Networks(jcfg)
    args = (jnp.asarray(img), jnp.asarray(mean_v), jnp.asarray(pp),
            jnp.asarray(foc), False)
    v = jax.jit(lambda k: jnet.init(k, *args))(jax.random.PRNGKey(5))
    stats = randomize_stats(v["batch_stats"], seed=9)
    jout = jax.jit(lambda p, s: jnet.apply({"params": p, "batch_stats": s},
                                           *args))(v["params"], stats)

    model = meshnet.MeshNet(cfg, constants).eval()
    sd = W.from_jax_params({"net": np_tree(v["params"]),
                            "mean_v": constants.mean_v_init}, np_tree(stats))
    model.load_state_dict(sd, strict=True)
    assert "encoder.backbone.resnet.layer2.0.downsample.0.weight" in sd
    assert "encoder.pose_predictor.rot_pred_layer.0.2.0.weight" in sd
    assert sd["encoder.featnet_mesh.conv1.weight"].shape == (16, 3, 1)
    with torch.no_grad():
        out = model.encoder(torch.tensor(img), torch.tensor(mean_v),
                            torch.tensor(pp), torch.tensor(foc))
    names = ("img_feat", "mesh_feat", "pred_v", "rotation", "translation",
             "scale")
    for n, a, b_ in zip(names, out, jout):
        np.testing.assert_allclose(t2n(a), np.asarray(b_), atol=ATOL,
                                   err_msg=n)
