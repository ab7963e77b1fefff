"""MeshNet composition and the eval forward (counterpart of
selfcorr_tpu/models/meshnet.py: MeshConstants, build_mesh_constants,
Networks, preprocess, forward_test).

`MeshNet` holds the trainable nets under `encoder` and the learnable
canonical shape as `mesh.mean_v`, so its state_dict uses the reference
checkpoint's names (see utils/weight_convert.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.models import correspondence as corr
from selfcorr_tpu_torch.models.heads import PosePredictor, ShapeDeformer
from selfcorr_tpu_torch.models.pointnet import MeshEncoder
from selfcorr_tpu_torch.models.resnet import Backbone, FPNDecoder
from selfcorr_tpu_torch.ops import geometry as G
from selfcorr_tpu_torch.ops import mesh_ops as M
from selfcorr_tpu_torch.ops.image_ops import color_jitter, grid_sample

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class MeshConstants(NamedTuple):
    """Static per-category constants, built host-side once."""
    mean_v_init: np.ndarray   # (V, 3)
    faces: np.ndarray         # (F, 3) int32
    symm_rots: np.ndarray     # (k, 3, 3)
    laplacian: np.ndarray     # (V, V)
    flatten_quads: tuple      # 4 x (E,) int32
    base_rot: np.ndarray      # (3, 3)


def build_mesh_constants(cfg: Config) -> MeshConstants:
    if cfg.shape_prior and cfg.shape_prior_path:
        verts, faces = M.load_obj(cfg.shape_prior_path)
        verts = M.normalize_prior(verts, cfg.init_scale)
    else:
        verts, faces = M.icosphere(cfg.subdivide)
        verts = verts * np.asarray(cfg.init_scale)
    verts = verts.astype(np.float32)
    faces = faces.astype(np.int32)
    return MeshConstants(
        mean_v_init=verts, faces=faces,
        symm_rots=G.symmetry_rotations(cfg.symmetry_idx),
        laplacian=M.laplacian_matrix(len(verts), faces),
        flatten_quads=M.flatten_quads(faces),
        base_rot=G.base_rotation(cfg.base_rot))


class Networks(nn.Module):
    """All trainable nets (the reference Encoder)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.n_corr_feat = cfg.n_corr_feat
        self.backbone = Backbone()
        self.featnet = FPNDecoder(out_channels=cfg.n_corr_feat,
                                  downsample=cfg.img_size // cfg.corr_h)
        self.featnet_mesh = MeshEncoder(cfg.n_corr_feat)
        self.shape_code_predictor = nn.Linear(512, cfg.codedim)
        self.shape_predictor = ShapeDeformer(
            code_dim=cfg.codedim, deform_ratio=cfg.deform_ratio,
            no_deform=cfg.no_deform)
        self.pose_predictor = PosePredictor(
            rotation_offset=tuple(cfg.rotation_offset),
            depth_offset=cfg.depth_offset, use_scale=cfg.use_scale)

    def encode_img(self, img):
        """img (B, H, W, 3) already jittered + ImageNet-normalized ->
        (img_code (B, 512), img_feat (B, P, C) L2-normalized)."""
        b = img.shape[0]
        feats = self.backbone(img)
        img_code = feats[-1].mean(dim=(1, 2))
        img_feat = self.featnet(feats).reshape(b, -1, self.n_corr_feat)
        return img_code, G.normalize(img_feat)

    def forward(self, img, mean_v, pp_crop, foc_crop):
        img_code, img_feat = self.encode_img(img)
        shape_code = self.shape_code_predictor(img_code)
        pred_v = self.shape_predictor(mean_v, shape_code)
        mesh_feat = G.normalize(self.featnet_mesh(pred_v.detach()))
        rotation, trans, scale = self.pose_predictor(img_code)
        pred_v = pred_v * scale[:, None, :]
        # principal-point compensation: shift xy so the predicted z is
        # depth along the crop's optical axis
        tz = trans[:, 2:].detach()
        txy = trans[:, :2] - (pp_crop / foc_crop) * tz
        translation = torch.cat([txy, trans[:, 2:]], -1)[:, None, :]
        return img_feat, mesh_feat, pred_v, rotation, translation, scale


class MeshParams(nn.Module):
    def __init__(self, mean_v_init: np.ndarray):
        super().__init__()
        self.mean_v = nn.Parameter(torch.as_tensor(mean_v_init,
                                                   dtype=torch.float32))


class MeshNet(nn.Module):
    def __init__(self, cfg: Config, constants: MeshConstants):
        super().__init__()
        self.encoder = Networks(cfg)
        self.mesh = MeshParams(constants.mean_v_init)


def preprocess(img, jitter=None, generator=None):
    """ColorJitter + ImageNet normalize. Eval jitters too, as the reference
    does (torchvision transforms are mode-agnostic); `jitter` holds the 4
    factors, else they are drawn from `generator`."""
    x = color_jitter(img, jitter, generator)
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (x - mean) / std


@torch.no_grad()
def forward_test(model: MeshNet, batch: dict, constants: MeshConstants,
                 cfg: Config, jitter=None, generator=None) -> dict:
    """Eval forward: prediction tuple incl. the forward-backward match
    confidence. `model` must be in eval mode (running BN statistics)."""
    img = batch["img"]
    b = img.shape[0]
    dev = img.device
    mean_v = model.mesh.mean_v[None].expand(b, -1, -1)
    net_in = preprocess(img, jitter, generator)
    img_feat, mesh_feat, pred_v, rotation, translation, scale = \
        model.encoder(net_in, mean_v, batch["pp_crop"], batch["foc_crop"])
    meshgrid = corr.make_meshgrid(cfg.corr_h, cfg.corr_w, device=dev)
    pointcorr, match_map, imatch, match_conf = corr.dual_softmax_match(
        img_feat, mesh_feat, batch["mask"], pred_v, meshgrid,
        cfg.tau_img, cfg.tau_mesh, cfg.corr_h, cfg.corr_w, compute_conf=True)
    tex = grid_sample(img, imatch)
    faces = torch.as_tensor(constants.faces, dtype=torch.long, device=dev)
    return dict(pred_v=pred_v, faces=faces, tex=tex, imatch=imatch,
                match=match_map, match_conf=match_conf, rotation=rotation,
                translation=translation, scale=scale, pointcorr=pointcorr)
