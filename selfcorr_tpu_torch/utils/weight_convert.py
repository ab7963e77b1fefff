"""JAX parameter trees -> the port's state_dict.

from_jax_params takes the JAX package's {"net": ..., "mean_v": ...} params
and its batch_stats, as nested dicts of numpy arrays, and returns a
state_dict for models.meshnet.MeshNet. The port's parameter names are the
reference checkpoint's (the names selfcorr_tpu/utils/weight_convert.py
convert_meshnet reads, :137), so importing a reference .pth later is a
rename. Layout rules:
  flax Conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
  flax Dense kernel (I, O)        -> Linear weight (O, I)
  flax Dense on points (I, O)     -> Conv1d(k=1) weight (O, I, 1)
  BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
                                         running_var
  LayerNorm scale / bias           -> weight / bias

from_jax_dino_params does the same for the frozen DINO trunk
(models/vit.DinoViTS8), whose names are the released checkpoint's, the keys
selfcorr_tpu/utils/weight_convert.py convert_dino_vits8 (:76) reads.

The imports, counterparts of that module's loaders (:221-335), each into a
module in place, on the CPU: load_torch_sd reads a .pth; load_pretrained_init
a torchvision resnet18 into the backbone and a released DINO ViT-S/8 into the
trunk; load_reference_ckpt a reference pred_net_*.pth into MeshNet;
load_warm_start the backbone and FPN of an earlier run's checkpoint. Every
import checks shapes, and a missing file raises FileNotFoundError.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from selfcorr_tpu_torch.utils import checkpoint


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def conv_w(k):
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def dense_w(k):
    return _t(np.asarray(k).transpose(1, 0))


def _dense(sd, prefix, p):
    sd[prefix + "weight"] = dense_w(p["kernel"])
    sd[prefix + "bias"] = _t(p["bias"])


def _bn(sd, prefix, p, s):
    sd[prefix + "weight"] = _t(p["scale"])
    sd[prefix + "bias"] = _t(p["bias"])
    sd[prefix + "running_mean"] = _t(s["mean"])
    sd[prefix + "running_var"] = _t(s["var"])
    sd[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def resnet18_state(params, stats) -> Dict[str, torch.Tensor]:
    """models/resnet.ResNet18 params + batch_stats -> ResNet18 state."""
    sd: dict = {}
    sd["conv1.weight"] = conv_w(params["conv1"]["kernel"])
    _bn(sd, "bn1.", params["BatchNorm_0"], stats["BatchNorm_0"])
    for layer in range(1, 5):
        for blk in range(2):
            p = params[f"layer{layer}_{blk}"]
            s = stats[f"layer{layer}_{blk}"]
            dst = f"layer{layer}.{blk}."
            sd[dst + "conv1.weight"] = conv_w(p["Conv_0"]["kernel"])
            _bn(sd, dst + "bn1.", p["BatchNorm_0"], s["BatchNorm_0"])
            sd[dst + "conv2.weight"] = conv_w(p["Conv_1"]["kernel"])
            _bn(sd, dst + "bn2.", p["BatchNorm_1"], s["BatchNorm_1"])
            if "downsample_conv" in p:
                sd[dst + "downsample.0.weight"] = conv_w(
                    p["downsample_conv"]["kernel"])
                _bn(sd, dst + "downsample.1.", p["BatchNorm_2"],
                    s["BatchNorm_2"])
    return sd


def fpn_state(params, stats) -> Dict[str, torch.Tensor]:
    """models/resnet.FPNDecoder params + batch_stats -> FPNDecoder state."""
    sd: dict = {}
    for name in ("upconv5", "iconv4", "upconv4", "iconv3", "upconv3",
                 "iconv2"):
        sd[f"{name}.cbr_unit.0.weight"] = conv_w(
            params[name]["Conv_0"]["kernel"])
        _bn(sd, f"{name}.cbr_unit.1.", params[name]["BatchNorm_0"],
            stats[name]["BatchNorm_0"])
    sd["proj.weight"] = conv_w(params["proj"]["kernel"])
    sd["proj.bias"] = _t(params["proj"]["bias"])
    return sd


def mesh_encoder_state(params) -> Dict[str, torch.Tensor]:
    """models/pointnet.MeshEncoder params -> MeshEncoder state."""
    sd: dict = {}
    for src, dst in (("stn", "stn."), (None, "")):
        p = params[src] if src else params
        sd[dst + "conv1.weight"] = dense_w(p["conv1"]["kernel"])[..., None]
        sd[dst + "conv1.bias"] = _t(p["conv1"]["bias"])
    _dense(sd, "stn.fc.", params["stn"]["fc"])
    return sd


def shape_deformer_state(params) -> Dict[str, torch.Tensor]:
    """models/heads.ShapeDeformer params -> ShapeDeformer state."""
    sd: dict = {}
    for src, dst in (("layer1", "layer1"), ("layer_xyz0", "layers_xyz.0"),
                     ("fc_feat", "fc_feat"), ("layer_dir0", "layers_dir.0"),
                     ("fc_rgb", "fc_rgb")):
        _dense(sd, f"shapenerf.{dst}.", params[src])
    return sd


def pose_predictor_state(params) -> Dict[str, torch.Tensor]:
    """models/heads.PosePredictor params -> PosePredictor state."""
    sd: dict = {}
    for i in range(3):
        _dense(sd, f"rot_pred_layer.0.{i}.0.", params[f"rot_fc{i}"])
    _dense(sd, "rot_pred_layer.1.", params["rot_out"])
    _dense(sd, "trans_pred_layer.", params["trans"])
    if "scale" in params:
        _dense(sd, "scale_pred_layer.", params["scale"])
    return sd


def _prefixed(prefix, sd):
    return {prefix + k: v for k, v in sd.items()}


def from_jax_params(params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX {"net": ..., "mean_v": ...} + batch_stats -> MeshNet
    state_dict."""
    net = params["net"]
    sd: dict = {"mesh.mean_v": _t(params["mean_v"])}
    sd.update(_prefixed("encoder.backbone.resnet.", resnet18_state(
        net["backbone"], batch_stats["backbone"])))
    sd.update(_prefixed("encoder.featnet.", fpn_state(
        net["featnet"], batch_stats["featnet"])))
    sd.update(_prefixed("encoder.featnet_mesh.",
                        mesh_encoder_state(net["featnet_mesh"])))
    _dense(sd, "encoder.shape_code_predictor.", net["shape_code_predictor"])
    if "shape_predictor" in net:
        sd.update(_prefixed("encoder.shape_predictor.",
                            shape_deformer_state(net["shape_predictor"])))
    sd.update(_prefixed("encoder.pose_predictor.",
                        pose_predictor_state(net["pose_predictor"])))
    return sd


def from_jax_dino_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX models/vit.DinoViTS8 params -> DinoViTS8 state_dict
    (patch_embed.proj.*, cls_token, pos_embed, blocks.{i}.*)."""
    sd: dict = {"patch_embed.proj.weight": conv_w(
                    params["patch_embed"]["kernel"]),
                "patch_embed.proj.bias": _t(params["patch_embed"]["bias"]),
                "cls_token": _t(params["cls_token"]),
                "pos_embed": _t(params["pos_embed"])}
    i = 0
    while f"block{i}" in params:
        p = params[f"block{i}"]
        dst = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[dst + norm + ".weight"] = _t(p[norm]["scale"])
            sd[dst + norm + ".bias"] = _t(p[norm]["bias"])
        _dense(sd, dst + "attn.qkv.", p["attn"]["qkv"])
        _dense(sd, dst + "attn.proj.", p["attn"]["proj"])
        _dense(sd, dst + "mlp.fc1.", p["mlp"]["fc1"])
        _dense(sd, dst + "mlp.fc2.", p["mlp"]["fc2"])
        i += 1
    return sd


# ---------------------------------------------------------------------------
# imports of torch checkpoints
# ---------------------------------------------------------------------------

# the subtrees a warm start copies: the ResNet18 backbone and the FPN
# decoder (the JAX package's "backbone" and "featnet"), not the PointNet
# encoder.featnet_mesh
WARM_START = ("encoder.backbone.", "encoder.featnet.")


def load_torch_sd(path: str) -> Dict[str, torch.Tensor]:
    """torch.load a checkpoint to the CPU -> {key: tensor}; unwraps a
    {"state_dict" | "model" | "teacher": ...} container and strips a
    "module." prefix (selfcorr_tpu/utils/weight_convert.py:221)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "teacher"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return {k.removeprefix("module."): v for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def _load(module: torch.nn.Module, values: Dict[str, torch.Tensor],
          source: str) -> None:
    """Copy `values` (keys of module.state_dict()) into `module`; raises
    ValueError if a shape differs."""
    own = module.state_dict()
    bad = [(k, tuple(v.shape), tuple(own[k].shape))
           for k, v in values.items() if v.shape != own[k].shape]
    if bad:
        raise ValueError(f"{source}: shapes differ from the model's "
                         f"(key, file, model): {bad[:5]}")
    module.load_state_dict(values, strict=False)


def _pick(sd: dict, keys, source: str, prefix: str = "") -> dict:
    missing = [prefix + k for k in keys if prefix + k not in sd]
    if missing:
        raise KeyError(f"{source}: {len(missing)} keys missing, e.g. "
                       f"{missing[:3]}")
    return {k: sd[prefix + k] for k in keys}


def resize_pos_embed(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """(1, 1 + g*g, C) position embeddings -> (1, 1 + grid*grid, C): the
    patch grid resized bicubically by F.interpolate on the CPU in float32,
    as the JAX package and the reference resize it
    (selfcorr_tpu/utils/weight_convert.py:94-100)."""
    pos = pos.float()
    g = int(round((pos.shape[1] - 1) ** 0.5))
    if g == grid:
        return pos
    patches = pos[0, 1:].reshape(g, g, -1).permute(2, 0, 1)
    patches = F.interpolate(patches[None], size=(grid, grid),
                            mode="bicubic")[0]
    return torch.cat([pos[:, :1], patches.permute(1, 2, 0).reshape(
        1, grid * grid, -1)], 1)


def load_pretrained_init(cfg, model, dino) -> None:
    """cfg.resnet_init_path: a torchvision resnet18 state dict (keys
    unprefixed when it has conv1.weight, else under
    encoder.backbone.resnet.; its fc head ignored) into the backbone,
    weights and BatchNorm statistics. cfg.dino_init_path: a released DINO
    ViT-S/8 state dict into the trunk (blocks past it ignored), the
    position embeddings resized to cfg.img_size // 8. An empty path leaves
    its module as it is (selfcorr_tpu/utils/weight_convert.py:239)."""
    if cfg.resnet_init_path:
        sd = load_torch_sd(cfg.resnet_init_path)
        prefix = "" if "conv1.weight" in sd else "encoder.backbone.resnet."
        resnet = model.encoder.backbone.resnet
        keys = [k for k in resnet.state_dict()
                if not k.endswith("num_batches_tracked")]
        _load(resnet, _pick(sd, keys, cfg.resnet_init_path, prefix),
              cfg.resnet_init_path)
    if cfg.dino_init_path:
        sd = load_torch_sd(cfg.dino_init_path)
        values = _pick(sd, dino.state_dict(), cfg.dino_init_path)
        values["pos_embed"] = resize_pos_embed(values["pos_embed"],
                                               cfg.img_size // 8)
        _load(dino, values, cfg.dino_init_path)


def load_reference_ckpt(path: str, model) -> None:
    """A reference pred_net_*.pth into MeshNet, whose names are the
    reference's: strict on shapes, lenient on keys the file lacks (the
    reference's strict=False load); a file that matches no key raises
    (selfcorr_tpu/utils/weight_convert.py:289)."""
    sd = load_torch_sd(path)
    own = model.state_dict()
    values = {k: v for k, v in sd.items() if k in own}
    if not values:
        raise ValueError(f"{path}: no key matches the model's (e.g. "
                         f"{sorted(sd)[:3]})")
    _load(model, values, path)


def load_warm_start(cfg, model) -> None:
    """The backbone and FPN decoder (WARM_START), with their BatchNorm
    buffers, from the port checkpoint at cfg.warm_start_path (a checkpoint
    directory, its latest step, or a step directory); the heads, mean_v, the
    PointNet and the trunk stay as they are. The rest of the checkpoint is
    not shape-checked, so a source written at another img_size loads
    (selfcorr_tpu/utils/weight_convert.py:310, which reads an orbax
    directory instead)."""
    src = checkpoint.restore_raw(cfg.warm_start_path)["model"]
    keys = [k for k in model.state_dict() if k.startswith(WARM_START)]
    _load(model, _pick(src, keys, cfg.warm_start_path), cfg.warm_start_path)
