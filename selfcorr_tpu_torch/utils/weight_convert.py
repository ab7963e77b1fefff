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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
