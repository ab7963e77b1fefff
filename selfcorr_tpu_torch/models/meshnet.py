"""MeshNet composition, the training forward and the eval forward
(counterpart of selfcorr_tpu/models/meshnet.py: MeshConstants,
build_mesh_constants, Networks, preprocess, weights_schedule,
render_products, forward_train, forward_test, forward_vis).

`MeshNet` holds the trainable nets under `encoder` and the learnable
canonical shape as `mesh.mean_v`, so its state_dict uses the reference
checkpoint's names (see utils/weight_convert.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.losses import (DIVIDE_FNS, camera_loss, deform_loss,
                                       depth_loss, depth_loss_chamfer,
                                       flatten_loss, imatch_loss,
                                       laplacian_loss, mask_pyramid_loss,
                                       match_loss, pullfar_loss,
                                       symmetry_loss, texture_loss)
from selfcorr_tpu_torch.models import correspondence as corr
from selfcorr_tpu_torch.models.heads import PosePredictor, ShapeDeformer
from selfcorr_tpu_torch.models.pointnet import MeshEncoder
from selfcorr_tpu_torch.models.resnet import Backbone, FPNDecoder, frozen_stats
from selfcorr_tpu_torch.models.surface_texture import surface_texture
from selfcorr_tpu_torch.ops import geometry as G
from selfcorr_tpu_torch.ops import mesh_ops as M
from selfcorr_tpu_torch.ops.image_ops import (color_jitter, grid_sample,
                                              jitter_factors)
from selfcorr_tpu_torch.ops.rasterizer import render_fused
from selfcorr_tpu_torch.ops.rasterizer.common import EYE_OFFSET
from selfcorr_tpu_torch.utils.tracing import span

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
        self.mean_v_init = np.asarray(mean_v_init, np.float32)
        self.mean_v = nn.Parameter(torch.as_tensor(self.mean_v_init))

    @torch.no_grad()
    def reset_parameters(self):
        """mean_v back to the prior (models/init.py)."""
        self.mean_v.copy_(torch.as_tensor(self.mean_v_init))


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


class DeviceConstants(NamedTuple):
    """The MeshConstants the training forward reads, on the device."""
    faces: torch.Tensor          # (F, 3) long
    symm_rots: torch.Tensor      # (k, 3, 3)
    laplacian: torch.Tensor      # (V, V)
    flatten_quads: tuple         # 4 x (E,) long


def device_constants(constants: MeshConstants, device) -> DeviceConstants:
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return DeviceConstants(
        faces=t(constants.faces, torch.long),
        symm_rots=t(constants.symm_rots), laplacian=t(constants.laplacian),
        flatten_quads=tuple(t(q, torch.long)
                            for q in constants.flatten_quads))


class StepDraws(NamedTuple):
    """The random draws of one training forward, in the order of the JAX
    package's jax.random.split(rng, 4) (meshnet.py:211): the color jitter
    of the input, the symmetry loss's surface samples, the rotation cycle's
    angle, and the color jitter of the rotated batch."""
    jitter: torch.Tensor         # (4,) brightness, contrast, saturation, hue
    sym_u: torch.Tensor          # (B, symmetry_npts, 1)
    sym_ub: torch.Tensor         # (B, symmetry_npts, 2)
    angle: torch.Tensor          # () degrees
    cycle_jitter: torch.Tensor   # (4,)
    chamfer_u: torch.Tensor | None = None   # (B, 2000, 1), depth chamfer
    chamfer_ub: torch.Tensor | None = None  # (B, 2000, 2)


def draw_step(generator: torch.Generator, cfg: Config, b: int) -> StepDraws:
    """One training forward's draws, on the CPU, from `generator`."""
    jitter = jitter_factors(generator)
    sym_u, sym_ub = M.surface_draws(generator, b, cfg.symmetry_npts)
    angle = corr.rotation_angle(generator)
    cycle_jitter = jitter_factors(generator)
    cu = cub = None
    if cfg.use_depth and cfg.depth_loss_chamfer:
        cu, cub = M.surface_draws(generator, b, 2000)
    return StepDraws(jitter, sym_u, sym_ub, angle, cycle_jitter, cu, cub)


def weights_schedule(step: int, cfg: Config) -> dict:
    """Per-iteration loss weights: linear from the base weight toward
    decay_ratio x base, down for the regularizers and cycle losses, up for
    match / imatch."""
    frac = min(max(step / cfg.total_iters, 0.0), 1.0)

    def down(w):
        return frac * (cfg.decay_ratio * w - w) + w

    def up(w):
        return frac * (w - cfg.decay_ratio * w) + cfg.decay_ratio * w

    return dict(
        mask=cfg.mask_wt, tex=cfg.tex_wt, depth=cfg.depth_wt,
        triangle=down(cfg.triangle_wt), symmetry=down(cfg.symmetry_wt),
        cycle=down(cfg.cycle_loss_wt),
        cycle_pt=down(cfg.cycle_loss_pretrain_wt),
        match=up(cfg.match_wt), imatch=up(cfg.imatch_wt),
        pullfar=cfg.pullfar_wt, deform=cfg.deform_wt, camera=cfg.camera_wt)


def render_products(pred_v, faces, tex, foc_crop, pp_crop, rotation,
                    translation, cfg: Config, surf_tex=None) -> dict:
    """Camera transform, one fused render (on the card kernels B1 forward
    and B2 backward, or B1' and B2' in the dense-chunk schedule) and the
    analytic per-vertex image matches and visibility weights. surf_tex
    (B, F, R^2, 3) switches the texture pass to per-face texel grids
    ('surface' mode)."""
    verts_cam = G.rigid_transform(pred_v, rotation, translation)
    proj = G.project_ndc(verts_cam, pp_crop, foc_crop, flip_y=True)
    rast = torch.cat([proj[..., :2], proj[..., 2:] + EYE_OFFSET], -1)
    out = render_fused(rast[:, faces], tex[:, faces],
                       pred_v.detach()[:, faces], cfg.img_size,
                       surf_tex=surf_tex)
    depth = out["depth"] if cfg.use_depth else out["depth"].detach()

    # analytic projected vertices (no y flip: image convention)
    imatch_gt = G.project_ndc(verts_cam, pp_crop, foc_crop,
                              flip_y=False)[..., :2].detach()
    vert_depth = verts_cam[..., 2].detach()
    depth_at = grid_sample(depth.detach()[..., None], imatch_gt)[..., 0]
    depth_weight = torch.exp(-5.0 * F.relu(vert_depth - depth_at))
    return dict(mask_render=out["alpha1"], tex_render=out["tex"],
                tex_mask=out["alpha2"], depth_render=depth,
                depth_mask=out["alpha1"], match_gt=out["match"],
                match_mask=out["alpha1"], imatch_gt=imatch_gt,
                depth_weight=depth_weight)


def forward_train(model: MeshNet, dino, batch: dict, dc: DeviceConstants,
                  cfg: Config, step: int, draws: StepDraws):
    """One training forward (selfcorr_tpu/models/meshnet.py:191-356):
    returns (total_loss, aux dict of scalar tensors). `model` is in train
    mode and its BatchNorm running statistics move once, on this batch;
    `dino` is the frozen DINO trunk. Terms whose weight is statically zero
    are skipped and logged as 0."""
    w = weights_schedule(step, cfg)
    img, mask = batch["img"], batch["mask"]
    b = img.shape[0]
    zero = torch.zeros((), device=img.device)
    faces = dc.faces
    mean_v = model.mesh.mean_v[None].expand(b, -1, -1)
    if cfg.shape_prior and not cfg.prior_deform:
        mean_v = mean_v.detach()

    with span("forward.encode"):
        img_feat, mesh_feat, pred_v, rotation, translation, _ = \
            model.encoder(preprocess(img, draws.jitter), mean_v,
                          batch["pp_crop"], batch["foc_crop"])
        meshgrid = corr.make_meshgrid(cfg.corr_h, cfg.corr_w,
                                      device=img.device)
        _, match_map, imatch, _ = corr.dual_softmax_match(
            img_feat, mesh_feat, mask, pred_v, meshgrid, cfg.tau_img,
            cfg.tau_mesh, cfg.corr_h, cfg.corr_w)
    with span("forward.render"):
        # vertex colours sampled at the matched pixels; with surface_texture
        # the render's texture pass takes per-face texel grids sampled at
        # imatch-interpolated points instead
        tex = grid_sample(img, imatch)
        surf = (surface_texture(img, imatch, faces, cfg.n_tex_sample)
                if cfg.surface_texture else None)
        r = render_products(pred_v, faces, tex, batch["foc_crop"],
                            batch["pp_crop"], rotation, translation, cfg,
                            surf_tex=surf)

    with span("forward.losses"):
        occ = batch.get("occ") if cfg.use_occ else None
        mask_l = w["mask"] * mask_pyramid_loss(mask, r["mask_render"],
                                               occ).mean()
        tex_l = (w["tex"] * texture_loss(img, mask, r["tex_render"],
                                         r["tex_mask"], occ).mean()
                 if cfg.tex_wt != 0.0 else zero)
        match_l = (w["match"] * match_loss(match_map, r["match_gt"],
                                           r["match_mask"], mask).mean()
                   if cfg.match_wt != 0.0 else zero)
        imatch_l = (w["imatch"] * imatch_loss(imatch, r["imatch_gt"],
                                              r["depth_weight"]).mean()
                    if cfg.imatch_wt != 0.0 else zero)
        total = mask_l + tex_l + match_l + imatch_l
        aux = dict(mask_loss=mask_l, texture_loss=tex_l, match_loss=match_l,
                   imatch_loss=imatch_l)

        if cfg.use_depth:
            if cfg.depth_loss_chamfer:
                depth_sub, _ = depth_loss_chamfer(
                    pred_v, faces, batch["depth"], r["depth_render"],
                    r["depth_mask"], mask, batch["pp_crop"],
                    batch["foc_crop"], rotation, translation,
                    u=draws.chamfer_u, ub=draws.chamfer_ub)
            else:
                depth_sub, _ = depth_loss(batch["depth"], r["depth_render"],
                                          r["depth_mask"], mask)
            aux["depth_loss"] = w["depth"] * depth_sub.mean()
            total = total + aux["depth_loss"]

        with span("loss.symmetry"):
            symm_l = (w["symmetry"] * symmetry_loss(
                pred_v, faces, dc.symm_rots, cfg.symmetry_npts,
                u=draws.sym_u, ub=draws.sym_ub)
                if cfg.symmetry_wt != 0.0 else zero)
        n_v = pred_v.shape[1]
        tri_l = w["triangle"] * laplacian_loss(pred_v, dc.laplacian) \
            * n_v / 64.0
        if cfg.flatten_loss:
            tri_l = tri_l + w["triangle"] * flatten_loss(
                pred_v, dc.flatten_quads) * 0.1 * math.sqrt(n_v / 64.0)
        pull_l = w["pullfar"] * pullfar_loss(translation)
        deform_l = w["deform"] * deform_loss(pred_v, mean_v)
        total = total + symm_l + tri_l + pull_l + deform_l
        aux.update(symmetry_loss=symm_l, triangle_loss=tri_l,
                   pullfar_loss=pull_l, deform_loss=deform_l)

    # frozen-DINO cross-frame cycle loss; pairs are formed on the batch
    divide = DIVIDE_FNS[cfg.divide_fn]
    rep = cfg.repeat
    bs = b // rep
    cyc_pt = cyc = zero
    pretrain = cfg.cycle_loss_pretrain_wt != 0.0
    if pretrain:
        # a bf16 trunk (--dino_bf16) on a bf16 image
        with span("forward.dino"), torch.no_grad():
            dino_feat = dino(img.to(dino.dtype)).float()

    # rotation-augmentation cycle loss: the rotated batch is normalized with
    # its own statistics, which do not enter the running statistics
    def encode_fn(x):
        x = preprocess(x, draws.cycle_jitter)
        with frozen_stats(model.encoder):
            return model.encoder.encode_img(x)[1]

    with span("forward.cycle"):
        if pretrain:
            dino_feat = dino_feat.reshape(b, -1, dino_feat.shape[-1])
            cyc_pt, _ = corr.dino_cycle_loss(
                divide(dino_feat, bs, rep), divide(mask, bs, rep),
                divide(r["depth_weight"], bs, rep),
                divide(img_feat, bs, rep), divide(mesh_feat, bs, rep),
                meshgrid, cfg.tau_img, cfg.tau_mesh, cfg.corr_h, cfg.corr_w,
                cfg.pretrain_k)
            cyc_pt = w["cycle_pt"] * cyc_pt
        if cfg.cycle_loss_wt != 0.0:
            cyc = w["cycle"] * corr.rotation_cycle_loss(
                draws.angle, img, mask, img_feat, encode_fn, meshgrid,
                cfg.tau_mesh, cfg.corr_h, cfg.corr_w)[0]
    total = total + cyc_pt + cyc
    aux.update(cycle_loss_pretrain=cyc_pt, cycle_loss=cyc)

    if cfg.camera_loss:
        rot2 = torch.roll(rotation.detach().reshape(-1, rep, 3, 3), -1,
                          dims=1).reshape(-1, 3, 3)
        aux["cam_loss"] = w["camera"] * camera_loss(rotation, rot2).mean()
        total = total + aux["cam_loss"]

    aux["total_loss"] = total
    return total, aux


@torch.no_grad()
def forward_test(model: MeshNet, batch: dict, constants: MeshConstants,
                 cfg: Config, jitter=None, generator=None,
                 batch_sum=None) -> dict:
    """Eval forward: prediction tuple incl. the forward-backward match
    confidence, whose threshold is a mean over the whole batch (batch_sum:
    see dual_softmax_match). `model` must be in eval mode (running BN
    statistics)."""
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
        cfg.tau_img, cfg.tau_mesh, cfg.corr_h, cfg.corr_w, compute_conf=True,
        batch_sum=batch_sum)
    tex = grid_sample(img, imatch)
    faces = torch.as_tensor(constants.faces, dtype=torch.long, device=dev)
    return dict(pred_v=pred_v, faces=faces, tex=tex, imatch=imatch,
                match=match_map, match_conf=match_conf, rotation=rotation,
                translation=translation, scale=scale, pointcorr=pointcorr)


@torch.no_grad()
def forward_vis(model: MeshNet, dino, batch: dict, constants: MeshConstants,
                cfg: Config, jitter=None, angle=None, cycle_jitter=None,
                generator=None) -> dict:
    """The products of the trainer's image panels
    (selfcorr_tpu/models/meshnet.py:359-437), in eval mode (running BN
    statistics; the model's mode is restored after): forward_test, the
    predicted mesh and the mean mesh under the predicted pose rendered
    (kernel B1 twice on the card), depth_loss's diff, the rotation cycle's
    matches, and the frozen-DINO pair matches of frames 0 and 1 (kernel B3
    in the trunk), which must be two frames of one video.

    The draws, as in the JAX package's split of its key: `jitter` (4,)
    the colour jitter of forward_test and of the cycle's source features,
    `angle` () the cycle's rotation in degrees, `cycle_jitter` (4,) the
    jitter of the rotated batch; absent ones come from `generator`."""
    img, mask = batch["img"], batch["mask"]
    b = img.shape[0]
    if jitter is None:
        jitter = jitter_factors(generator)
    if angle is None:
        angle = corr.rotation_angle(generator)
    if cycle_jitter is None:
        cycle_jitter = jitter_factors(generator)
    training = model.training
    model.eval()
    try:
        out = forward_test(model, batch, constants, cfg, jitter=jitter)
        faces = out["faces"]
        args = (batch["foc_crop"], batch["pp_crop"], out["rotation"],
                out["translation"], cfg)
        vis = dict(out)
        vis.update(render_products(out["pred_v"], faces, out["tex"], *args))
        # the canonical mean shape under the predicted pose
        mean_v = model.mesh.mean_v[None].expand(b, -1, -1)
        rm = render_products(mean_v, faces, torch.zeros_like(out["tex"]),
                             *args)
        vis.update(mean_v_depth=rm["depth_render"],
                   mean_v_mask=rm["depth_mask"])
        if cfg.use_depth:
            vis["depth_diff"] = depth_loss(batch["depth"],
                                           vis["depth_render"],
                                           vis["depth_mask"], mask)[1]

        img_feat = model.encoder.encode_img(preprocess(img, jitter))[1]

        def encode_fn(x):
            return model.encoder.encode_img(preprocess(x, cycle_jitter))[1]

        meshgrid = corr.make_meshgrid(cfg.corr_h, cfg.corr_w,
                                      device=img.device)
        _, cycle_match, cycle_gt, cycle_mask = corr.rotation_cycle_loss(
            angle, img, mask, img_feat, encode_fn, meshgrid, cfg.tau_mesh,
            cfg.corr_h, cfg.corr_w)
        vis.update(cycle_match=cycle_match, cycle_match_gt=cycle_gt,
                   cycle_mask=cycle_mask)
    finally:
        model.train(training)

    dino_feat = dino(img[:2])
    dino_feat = dino_feat.reshape(2, -1, dino_feat.shape[-1])
    dw, pc = vis["depth_weight"], out["pointcorr"]
    _, pair = corr.dino_cycle_loss_dense(
        (dino_feat[0:1], dino_feat[1:2]), (mask[0:1], mask[1:2]),
        (dw[0:1], dw[1:2]), (pc[0:1], pc[1:2]), meshgrid, cfg.tau_img,
        cfg.tau_mesh, cfg.corr_h, cfg.corr_w,
        min(cfg.pretrain_k, (cfg.corr_h // 2) * (cfg.corr_w // 2)))
    vis.update(pt_pts_src=pair["pts_src"], pt_pts_tgt=pair["pts_tgt"],
               pt_match=pair["match"], pt_mask=pair["mask"])
    return vis
