"""The port's weight imports against the JAX package's, on the CPU at the
port tests' small shapes (img 32, corr 8^2, icosphere(1), batch 4):
--resnet_init_path and --dino_init_path (selfcorr_tpu/utils/weight_convert.py
load_pretrained_init), --model_path with a reference pred_net_*.pth
(load_reference_ckpt) and --warm_start_path (load_warm_start).

Every file is built here from seeded weights and written with torch.save:
no pretrained file is in the repository. Both packages start from the JAX
initialization (carried into the port by from_jax_params /
from_jax_dino_params) and import the same file, except the warm start: the
JAX package reads its own orbax checkpoint and the port its own, both
holding the same weights. The results must agree within 1e-6; the resized
DINO position embedding bit for bit, since both resize with the same CPU
F.interpolate. One JAX initialization is shared by the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfcorr_tpu.configs import Config as JConfig
from selfcorr_tpu.models import meshnet as JM
from selfcorr_tpu.train.step import init_state as jax_init_state
from selfcorr_tpu.utils import checkpoint as jax_ckpt
from selfcorr_tpu.utils import weight_convert as JW
from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.loader import TestLoader
from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
from selfcorr_tpu_torch.models.meshnet import (MeshNet, build_mesh_constants,
                                               forward_test)
from selfcorr_tpu_torch.models.vit import DinoViTS8
from selfcorr_tpu_torch.train.step import init_state
from selfcorr_tpu_torch.utils import checkpoint as ckpt
from selfcorr_tpu_torch.utils import weight_convert as W
from tests.test_torch_parity import _make_dino_sd, make_reference_sd
from tests.test_torch_slice import jitter_factors, randomize_stats
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SMALL = dict(dataset_name="synthetic", img_size=32, corr_h=8, corr_w=8,
             subdivide=1, batch_size=4, repeat=1, symmetry_idx=0,
             use_depth=True, n_corr_feat=16, codedim=8, depth_offset=5.0,
             eval=True, eval_nocs=True, dframe_eval=3,
             pose_fit_max_points=512, ransac_iters=8, num_workers=2,
             dino_attn_bf16=False)
ATOL = 1e-6


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    """The JAX train states from keys 0 (the receiver) and 7 (the donor,
    BatchNorm statistics randomized, mean_v perturbed), and the port's
    constants."""
    jcfg = JConfig(**SMALL)
    constants = JM.build_mesh_constants(jcfg)
    init = jax.jit(lambda k: jax_init_state(jcfg, constants, k))
    base = init(jax.random.PRNGKey(0))
    donor = init(jax.random.PRNGKey(7))
    mv = np.asarray(donor.params["mean_v"])
    mv = mv + np.random.RandomState(5).randn(*mv.shape).astype(
        np.float32) * 0.02
    donor = donor._replace(params={**donor.params, "mean_v": jnp.asarray(mv)},
                           batch_stats=randomize_stats(donor.batch_stats))
    cfg = Config(device="cpu", **SMALL)
    return dict(jcfg=jcfg, constants=constants, base=base, donor=donor,
                cfg=cfg, pconst=build_mesh_constants(cfg))


def port_modules(sh, state):
    """The port's MeshNet and DINO trunk holding a JAX state's weights."""
    model = MeshNet(sh["cfg"], sh["pconst"])
    model.load_state_dict(W.from_jax_params(to_np(state.params),
                                            to_np(state.batch_stats)))
    dino = DinoViTS8(img_size=sh["cfg"].img_size, attn_bf16=False)
    dino.load_state_dict(W.from_jax_dino_params(to_np(state.dino_params)))
    return model, dino


def assert_close(got: dict, want: dict, atol=ATOL):
    assert sorted(got) == sorted(want)
    bad = [(k, float((got[k].double() - want[k].double()).abs().max()))
           for k in want if got[k].shape != want[k].shape
           or not float((got[k].double() - want[k].double()).abs().max())
           <= atol]
    assert not bad, bad[:10]


def resnet18_file(sh, rng):
    """A torchvision-named resnet18 state dict (the port's backbone names,
    which are torchvision's) of seeded weights, with the fc head an import
    ignores."""
    names = MeshNet(sh["cfg"], sh["pconst"]).encoder.backbone.resnet \
        .state_dict()
    sd = {}
    for k, v in names.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = torch.tensor(rng.uniform(0.5, 1.5, v.shape),
                                 dtype=torch.float32)
        else:
            sd[k] = torch.tensor(rng.randn(*v.shape) * 0.05,
                                 dtype=torch.float32)
    sd["fc.weight"] = torch.tensor(rng.randn(1000, 512), dtype=torch.float32)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("layout", ["torchvision", "wrapped"])
def test_pretrained_init_matches_jax(shared, tmp_path, layout):
    """A torchvision resnet18 (plain, or as a {"model": ...} container
    with module.encoder.backbone.resnet. keys) and a released-layout DINO
    ViT-S/8 at grid 7 with all 12 blocks: the port's init_state with both
    paths equals the JAX init_state's, the trunk's position embedding
    resized to grid 4 bit for bit."""
    rng = np.random.RandomState(0)
    rsd = resnet18_file(shared, rng)
    if layout == "wrapped":
        rsd = {"model": {"module.encoder.backbone.resnet." + k: v
                         for k, v in rsd.items() if not k.startswith("fc.")}}
    dsd = {k: torch.tensor(v) for k, v in _make_dino_sd(
        rng, g=7, n_blocks=12).items()}
    dsd["norm.weight"], dsd["norm.bias"] = torch.ones(384), torch.zeros(384)
    rpath, dpath = str(tmp_path / "resnet18.pth"), str(tmp_path / "dino.pth")
    torch.save(rsd, rpath)
    torch.save(dsd, dpath)

    paths = dict(resnet_init_path=rpath, dino_init_path=dpath)
    # what the JAX init_state does with both paths set (step.py:57-62)
    loaded = JW.load_pretrained_init(shared["jcfg"].replace(**paths),
                                     shared["base"])
    model, dino = port_modules(shared, shared["base"])
    st = init_state(shared["cfg"].replace(**paths), shared["pconst"], "cpu",
                    model=model, dino=dino)
    assert_close(st.model.state_dict(), W.from_jax_params(
        to_np(loaded.params), to_np(loaded.batch_stats)))
    want_dino = W.from_jax_dino_params(to_np(loaded.dino_params))
    assert_close(st.dino.state_dict(), want_dino)
    assert st.dino.pos_embed.shape == (1, 17, 384)
    assert torch.equal(st.dino.pos_embed.detach(), want_dino["pos_embed"])
    assert torch.equal(st.dino.blocks[9].mlp.fc2.weight.detach(),
                       dsd["blocks.9.mlp.fc2.weight"])
    conv1 = rsd["model"]["module.encoder.backbone.resnet.conv1.weight"] \
        if layout == "wrapped" else rsd["conv1.weight"]
    assert torch.equal(
        st.model.encoder.backbone.resnet.conv1.weight.detach(), conv1)


def test_reference_checkpoint_matches_jax(shared, tmp_path):
    """A reference pred_net_*.pth of the donor's weights through
    --model_path: the port's Tester holds the weights the JAX
    load_reference_ckpt gives, and forward_test of the two packages agrees
    on one batch within the predict path's 1e-3."""
    donor = to_np(shared["donor"].params)
    sd = make_reference_sd(donor["net"], to_np(shared["donor"].batch_stats),
                           donor["mean_v"])
    path = str(tmp_path / "pred_net_20000.pth")
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, path)

    loaded = JW.load_reference_ckpt(path, shared["base"])
    tester = Tester(shared["cfg"].replace(
        train=False, model_path=path, checkpoint_dir=str(tmp_path)))
    assert_close(tester.model.state_dict(), W.from_jax_params(
        to_np(loaded.params), to_np(loaded.batch_stats)))

    loader = TestLoader(make_test_dataset(tester.cfg), tester.cfg)
    batch = next(iter(loader))
    loader.close()
    jcfg = shared["jcfg"].replace(train=False)
    key = jax.random.PRNGKey(42)
    jb = {k: jnp.asarray(batch[k]) for k in ("img", "mask", "depth", "occ",
                                             "pp_crop", "foc_crop")}
    jpred = jax.jit(lambda p, s, b, r: JM.forward_test(
        p, s, b, shared["constants"], r, jcfg))(
        loaded.params, loaded.batch_stats, jb, key)
    pred = forward_test(tester.model, tester.to_device(batch),
                        tester.constants, tester.cfg,
                        jitter=jitter_factors(key))
    for k in ("pred_v", "tex", "imatch", "match", "match_conf", "rotation",
              "translation", "scale"):
        np.testing.assert_allclose(pred[k].detach().numpy(),
                                   np.asarray(jpred[k]), atol=1e-3, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("fault", ["shape", "no_key"])
def test_reference_checkpoint_refuses_other_models(shared, tmp_path, fault):
    donor = to_np(shared["donor"].params)
    sd = {k: torch.tensor(np.asarray(v)) for k, v in make_reference_sd(
        donor["net"], to_np(shared["donor"].batch_stats),
        donor["mean_v"]).items()}
    if fault == "shape":
        sd["encoder.featnet.proj.weight"] = torch.zeros(3, 3, 1, 1)
    else:
        sd = {"head.weight": torch.zeros(3)}
    path = str(tmp_path / "pred_net_x.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shapes differ|no key"):
        Tester(shared["cfg"].replace(train=False, model_path=path,
                                     checkpoint_dir=str(tmp_path)))


def test_warm_start_matches_jax(shared, tmp_path):
    """The donor's weights as a JAX orbax checkpoint and as a port
    checkpoint: the JAX warm start from the one equals the port's from the
    other (backbone and FPN from the donor, the rest the receiver's)."""
    jdir, pdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jax_ckpt.save_state(jdir, shared["donor"], 1)
    model, dino = port_modules(shared, shared["donor"])
    ckpt.save_state(pdir, init_state(shared["cfg"], shared["pconst"], "cpu",
                                     model=model, dino=dino), 1)

    loaded = JW.load_warm_start(shared["jcfg"].replace(warm_start_path=jdir),
                                shared["base"])
    model, dino = port_modules(shared, shared["base"])
    st = init_state(shared["cfg"].replace(warm_start_path=pdir),
                    shared["pconst"], "cpu", model=model, dino=dino)
    want = W.from_jax_params(to_np(loaded.params),
                             to_np(loaded.batch_stats))
    assert_close(st.model.state_dict(), want)
    donor_sd = W.from_jax_params(to_np(shared["donor"].params),
                                 to_np(shared["donor"].batch_stats))
    for k in ("encoder.backbone.resnet.layer4.1.bn2.running_var",
              "encoder.featnet.iconv2.cbr_unit.1.running_mean"):
        assert torch.equal(st.model.state_dict()[k], donor_sd[k]), k


def test_warm_start_across_img_sizes_leaves_the_rest_at_init(shared,
                                                             tmp_path):
    """A port checkpoint written at img 32 warm-starts img 64 (corr 16^2:
    the FPN's stride, img / corr, is the source's): the backbone and the FPN
    (encoder.featnet.*), with their BatchNorm buffers, are the source's;
    the PointNet (encoder.featnet_mesh.*, which a prefix test on
    "encoder.featnet" would also take), the heads, mean_v and the trunk
    (whose pos_embed has another length) are a fresh init's."""
    src_cfg = shared["cfg"].replace(seed=1)
    src = init_state(src_cfg, shared["pconst"], "cpu")
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for name, buf in src.model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.tensor(rng.uniform(0.5, 1.5, buf.shape)))
    ckpt.save_state(str(tmp_path / "src"), src, 1)

    cfg64 = shared["cfg"].replace(img_size=64, corr_h=16, corr_w=16)
    pconst = build_mesh_constants(cfg64)
    fresh = init_state(cfg64, pconst, "cpu")
    warm = init_state(cfg64.replace(warm_start_path=str(tmp_path / "src")),
                      pconst, "cpu")
    s_sd, f_sd = src.model.state_dict(), fresh.model.state_dict()
    w_sd = warm.model.state_dict()
    copied = [k for k in w_sd if k.startswith(W.WARM_START)]
    assert any(".running_var" in k for k in copied)
    assert any(k.startswith("encoder.featnet.") for k in copied)
    for k, v in w_sd.items():
        want = s_sd[k] if k in copied else f_sd[k]
        assert torch.equal(v, want), k
    mesh_enc = [k for k in w_sd if k.startswith("encoder.featnet_mesh.")]
    assert mesh_enc and not any(k in copied for k in mesh_enc)
    assert any(not torch.equal(w_sd[k], s_sd[k]) for k in mesh_enc)
    heads = [k for k in w_sd if k.startswith(("encoder.pose_predictor.",
                                              "encoder.shape_predictor."))]
    assert any(not torch.equal(w_sd[k], s_sd[k]) for k in heads)
    assert warm.dino.pos_embed.shape == (1, 65, 384)
    assert all(torch.equal(v, fresh.dino.state_dict()[k])
               for k, v in warm.dino.state_dict().items())


@pytest.mark.parametrize("flag", ["resnet_init_path", "dino_init_path",
                                  "warm_start_path"])
def test_missing_import_file_raises(shared, tmp_path, flag):
    model, dino = port_modules(shared, shared["base"])
    with pytest.raises(FileNotFoundError):
        init_state(shared["cfg"].replace(**{flag: str(tmp_path / "none")}),
                   shared["pconst"], "cpu", model=model, dino=dino)


def test_pos_embed_resize_matches_jax():
    """resize_pos_embed at the released grid (28) to img 256's (32), bit
    for bit against the JAX converter's resize."""
    rng = np.random.RandomState(1)
    sd = _make_dino_sd(rng, g=28, n_blocks=1)
    want = JW.convert_dino_vits8(sd, feature_layer=0,
                                 target_grid=32)["pos_embed"]
    got = W.resize_pos_embed(torch.tensor(sd["pos_embed"]), 32)
    assert got.shape == (1, 1025, 384)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(W.resize_pos_embed(got, 32), got)
