"""Evaluation driver (counterpart of selfcorr_tpu/eval/tester.py), single
device: per batch the eval forward and the whole-batch RANSAC pose fit run
on the device; the exact 3D IoU / deg-cm metrics (--eval_nocs) run on the
host. The test split is Wild6D, NOCS, CUB or the synthetic set
(--dataset_name). With --eval_cub the fitted mesh's mask is rendered at
img_size (the fused rasterizer: the CUDA kernel on a CUDA device) and
scored by mask IoU, and the keypoints of each batch's first half are
carried to its second half through the match fields (PCK at 0.1 and 0.2).
The weights come from --model_path (a port checkpoint or a reference
.pth), else from --seed; the run's flags go to
checkpoint_dir/name/config-test.txt.

With --vis_pred each valid sample's panels go to --vis_path (default
checkpoint_dir/name/vis) as <video>_<frame>_<panel>.png (utils/vis, numpy
drawing written by Pillow): pasted into the original frame when the
dataset reads it, with the fitted mesh re-rendered under the frame's
intrinsics into depth / texture / mask panels (the fused rasterizer); on
the crop when the frame cannot be read, and for CUB, which also gets its
keypoint-transfer panels (_1, _2, _2_gt). --visualize_* choose panels;
none of them means all. A rasterizer build or launch error propagates.

Across ranks (parallel.launch; --batch_size is the global batch, split
evenly) each rank loads and evaluates its rows of every global batch and
writes its own rows' panels. Its jitter and RANSAC draws are the global
batch's, drawn from the Tester's generator and sliced, and the match
confidence's threshold (a mean over the whole batch) is summed across the
ranks, so the metrics do not depend on the number of ranks. The NOCS
accumulators are gathered, and every rank returns the whole run's metrics
(rank 0 prints them). --eval_cub pairs the first and second halves of a
batch, so it runs on one rank only.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.loader import BATCH_KEYS, TestLoader
from selfcorr_tpu_torch.eval.metrics import NocsAccumulator, map_kp, mask_iou
from selfcorr_tpu_torch.eval.pose_fit import fit_poses
from selfcorr_tpu_torch.models.init import init_model
from selfcorr_tpu_torch.models.meshnet import (MeshNet, build_mesh_constants,
                                               forward_test)
from selfcorr_tpu_torch.ops import geometry as G
from selfcorr_tpu_torch.ops.image_ops import jitter_factors
from selfcorr_tpu_torch.ops.rasterizer import render_fused
from selfcorr_tpu_torch.ops.rasterizer.common import EYE_OFFSET
from selfcorr_tpu_torch import parallel as P
from selfcorr_tpu_torch.utils import checkpoint as ckpt
from selfcorr_tpu_torch.utils.device import resolve_device
from selfcorr_tpu_torch.utils.logging import write_config_snapshot
from selfcorr_tpu_torch.utils.tracing import span
from selfcorr_tpu_torch.utils.imageio import to_u8, write_png
from selfcorr_tpu_torch.utils.vis import (draw_kp, panels_on,
                                          save_visualizations)
from selfcorr_tpu_torch.utils.weight_convert import load_reference_ckpt


def _tag(batch, i) -> str:
    """<video>_<frame> of sample i: the panels' file-name prefix."""
    return f"{int(batch['idx'][i]):03d}_{int(batch['frame_idx'][i]):03d}"


def make_test_dataset(cfg: Config):
    if cfg.dataset_name == "Wild6D":
        from selfcorr_tpu_torch.data.wild6d import Wild6DTest
        return Wild6DTest(cfg)
    if cfg.dataset_name == "synthetic":
        from selfcorr_tpu_torch.data.synthetic import SyntheticTest
        return SyntheticTest(cfg, shape=cfg.synthetic_shape)
    if cfg.dataset_name == "nocs":
        from selfcorr_tpu_torch.data.nocs import NOCSTest
        return NOCSTest(cfg)
    if cfg.dataset_name == "cub":
        from selfcorr_tpu_torch.data.cub import CUBTest
        return CUBTest(cfg)
    raise ValueError(f"unknown dataset {cfg.dataset_name!r}: Wild6D, "
                     f"synthetic, nocs or cub")


def load_model(model: MeshNet, path: str) -> None:
    """--model_path into `model` (selfcorr_tpu/eval/tester.py:60-65): a
    path ending in .pth is a reference pred_net_*.pth; any other is a port
    checkpoint (a checkpoint directory, its latest step, or a step
    directory), of which the model and its BatchNorm buffers are loaded,
    not the optimizer. A missing path raises FileNotFoundError."""
    if path.endswith(".pth"):
        load_reference_ckpt(path, model)
    else:
        model.load_state_dict(ckpt.restore_raw(path)["model"])


def merge_accumulators(acc: NocsAccumulator, parts) -> None:
    """Replace acc's samples by those of every rank: parts holds each
    rank's (iou_hits, degcm_hits, raw), in rank order (the JAX package's
    _merge_across_processes)."""
    acc.iou_hits = [h for p in parts for h in p[0]]
    acc.degcm_hits = [h for p in parts for h in p[1]]
    acc.raw = [r for p in parts for r in p[2]]


class Tester:
    __test__ = False  # not a pytest class

    def __init__(self, cfg: Config, model: MeshNet | None = None,
                 rank: P.Rank | None = None):
        P.require_rank(cfg, rank)
        self.rank = rank.rank if rank else 0
        self.world = rank.world if rank else 1
        self.group = rank.group if rank else None
        self.is_main = P.is_main()
        if self.world > 1 and cfg.eval_cub:
            raise NotImplementedError(
                "--eval_cub pairs the first and second halves of each "
                "batch (the keypoint transfer), which rows split over "
                "ranks would pair differently: evaluate CUB on one rank")
        self.row_range = P.process_row_range(self.rank, self.world,
                                             cfg.batch_size)
        self.cfg = cfg
        self.device = rank.device if rank else resolve_device(cfg.device)
        self.run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        self.vis_dir = cfg.vis_path or os.path.join(self.run_dir, "vis")
        if self.is_main:
            write_config_snapshot(self.run_dir, cfg, "config-test.txt")
        self.constants = build_mesh_constants(cfg)
        if model is None:
            model = init_model(cfg, self.constants)
        if cfg.model_path:
            load_model(model, cfg.model_path)
        self.model = model.to(self.device).eval()
        if self.group is not None:
            P.broadcast_module(self.model, group=self.group)
        self.base_rot = torch.as_tensor(self.constants.base_rot,
                                        device=self.device)
        self.generator = torch.Generator().manual_seed(cfg.seed + 123)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the global batch's ranks (the match confidence's
        threshold is a mean over the whole batch)."""
        return t if self.group is None else P.all_sum(t, self.group)

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device)
                for k, v in batch.items() if k in BATCH_KEYS}

    def predict_batch(self, batch: dict, jitter=None, sample_idx=None):
        """Forward + pose fit of one host batch, this rank's rows of a
        global batch of world x as many. jitter (4,) and sample_idx (B,
        ransac_iters, 5) are the draws; absent ones come from the Tester's
        generator, for the global batch (jitter, then the RANSAC uniforms
        of every row), of which this rank takes its rows. The call is a
        unit of utils/tracing.py, with its upload as a span."""
        cfg = self.cfg
        with span("predict_batch"):
            with span("predict.upload"):
                tb = self.to_device(batch)
            if jitter is None:
                jitter = jitter_factors(self.generator)
            u = None
            if sample_idx is None:
                b = len(batch["img"])
                u = torch.rand((b * self.world, cfg.ransac_iters, 5),
                               generator=self.generator)[
                    self.rank * b: (self.rank + 1) * b]
            pred = forward_test(self.model, tb, self.constants, cfg,
                                jitter=jitter, batch_sum=self.batch_sum)
            fit = fit_poses(pred["match"], pred["match_conf"], tb["depth"],
                            tb["mask"], tb["pp_crop"], tb["foc_crop"],
                            pred["pred_v"], self.base_rot,
                            max_points=cfg.pose_fit_max_points,
                            n_iters=cfg.ransac_iters, sample_idx=sample_idx,
                            sample_u=u)
            return pred, fit

    def test(self, dataset=None) -> dict:
        """Evaluate `dataset` (by default the cfg's test split,
        make_test_dataset) and return the metrics."""
        cfg = self.cfg
        if dataset is None:
            dataset = make_test_dataset(cfg)
        loader = TestLoader(dataset, cfg, self.row_range)
        acc = NocsAccumulator(cfg.symmetry_idx) if cfg.eval_nocs else None
        cub_iou, cub_pck = [], []
        try:
            for bi, batch in enumerate(loader):
                pred, fit = self.predict_batch(batch)
                valid = batch["valid"]
                if acc is not None and "rot_gt" in batch:
                    bbox9 = fit["bbox9"].cpu().numpy()
                    for i in np.flatnonzero(valid):
                        acc.add(bbox9[i], batch["rot_gt"][i],
                                batch["trans_gt"][i], batch["scale_gt"][i])
                if cfg.eval_cub and "kp" in batch:
                    ious, pck = self._eval_cub(batch, pred, fit)
                    cub_iou += ious
                    cub_pck += pck
                if cfg.vis_pred:
                    self._write_panels(dataset, batch, pred, fit)
                if self.is_main and (bi + 1) % 10 == 0:
                    print(f"tested batch {bi + 1}/{len(loader)}")
        finally:
            loader.close()

        results = {}
        if acc is not None:
            if self.group is not None:
                merge_accumulators(acc, P.gather_objects(
                    (acc.iou_hits, acc.degcm_hits, acc.raw), self.group))
            results = acc.summary()
            if self.is_main:
                for k in NocsAccumulator.KEYS:
                    print(f"{k}:", results[k])
        if cfg.eval_cub and cub_iou:
            pck = np.asarray(cub_pck, np.float64).reshape(-1, 2)
            results["mIoU"] = float(np.mean(cub_iou))
            results["kp@0.1"] = float(pck[:, 0].mean())
            results["kp@0.2"] = float(pck[:, 1].mean())
            for k in ("mIoU", "kp@0.1", "kp@0.2"):
                print(f"{k}:", results[k])
        return results

    def fitted_alpha(self, batch, pred, fit) -> torch.Tensor:
        """(B, S, S) alpha1 of each fitted mesh rendered at img_size under
        its crop's intrinsics (the fused rasterizer, textures all ones)."""
        dev = self.device
        proj = G.project_ndc(fit["verts"],
                             torch.as_tensor(batch["pp_crop"], device=dev),
                             torch.as_tensor(batch["foc_crop"], device=dev),
                             flip_y=True)
        rast = torch.cat([proj[..., :2], proj[..., 2:] + EYE_OFFSET], -1)
        fv = rast[:, pred["faces"]]
        ones = torch.ones_like(fv)
        return render_fused(fv, ones, ones, self.cfg.img_size)["alpha1"]

    def _eval_cub(self, batch, pred, fit):
        """([mask IoU of each valid sample], [[PCK@0.1, PCK@0.2] of each
        transferred keypoint]) of one batch. The mask is the fitted mesh's
        render (fitted_alpha) above 0.5. CUB has no depth, so every fit
        takes fit_poses' default pose, as in the JAX package. The keypoints
        of the batch's first half go to its second half through the match
        fields; the error is scaled by the crop's padding (1 + 2 * 0.2) /
        2. With --vis_pred each valid pair's keypoint panels go to
        vis_dir: <tag>_1 (source), _2 (the transferred keypoints on the
        target), _2_gt (the target's own), tagged by the source."""
        mask_render = (self.fitted_alpha(batch, pred, fit) > 0.5).cpu().numpy()
        valid = batch["valid"]
        ious = mask_iou(np.asarray(batch["mask"]), mask_render)
        cub_iou = [float(v) for v, ok in zip(ious, valid) if ok]

        half = len(valid) // 2
        kps = np.asarray(batch["kp"], np.float32)
        match = pred["match"].cpu().numpy()
        mask = np.asarray(batch["mask"])
        vis = (kps[..., 2] > 0).astype(np.float32)
        transfer, err, _, kp_mask = map_kp(
            vis[:half], vis[half: 2 * half], kps[:half], kps[half: 2 * half],
            match[:half], match[half: 2 * half], mask[:half],
            mask[half: 2 * half])
        if self.cfg.vis_pred:
            os.makedirs(self.vis_dir, exist_ok=True)
            img = np.asarray(batch["img"], np.float32)
            for i in range(half):
                if not (valid[i] and valid[i + half]):
                    continue
                panels = draw_kp(img[i], img[i + half], kps[i],
                                 kps[i + half], transfer[i], kp_mask[i])
                tag = _tag(batch, i)
                for suffix, panel in zip(("1", "2", "2_gt"), panels):
                    write_png(os.path.join(self.vis_dir,
                                           f"{tag}_{suffix}.png"), panel)
        kp_scale = (1 + 2 * 0.2) / 2
        pck = [[e * kp_scale < 0.1, e * kp_scale < 0.2]
               for e in err[kp_mask > 0]]
        return cub_iou, pck

    def _write_panels(self, dataset, batch, pred, fit):
        """Each valid sample's panels (utils/vis.save_visualizations): in
        its original frame, with the render panels, when the dataset reads
        one (read_original; not for CUB, as in the JAX package), else on
        the crop. A frame that cannot be read puts that sample's panels on
        the crop."""
        read_orig = (None if self.cfg.eval_cub
                     else getattr(dataset, "read_original", None))
        pred_np = {k: v.cpu().numpy() for k, v in pred.items()}
        fit_np = {k: v.cpu().numpy() for k, v in fit.items()}
        for i in np.flatnonzero(batch["valid"]):
            orig = renders = None
            if read_orig is not None:
                vid, fid = int(batch["idx"][i]), int(batch["frame_idx"][i])
                try:
                    orig = read_orig(vid, fid)
                except (OSError, KeyError, ValueError) as e:
                    print(f"[vis] original frame {vid}/{fid} unavailable "
                          f"({e}); its panels are drawn on the crop")
                else:
                    renders = self._debug_panels(batch, pred, fit, i, orig)
            save_visualizations(self.vis_dir, _tag(batch, i), batch, pred_np,
                                fit_np, i, self.cfg, orig=orig,
                                renders=renders)

    def _debug_panels(self, batch, pred, fit, i, orig) -> dict:
        """Full-frame depth / texture / mask panels: the FITTED mesh
        re-rendered with the original frame's intrinsics (per-axis NDC),
        rendered at s = h and resized to (h, w): those the --visualize_*
        flags ask for (utils/vis.panels_on). Returns name -> uint8 (h, w, 3)
        RGB, nothing rendered when none is asked for."""
        on = panels_on(self.cfg)
        want = [n for n in ("depth", "tex", "mask") if on(f"visualize_{n}")]
        if not want:
            return {}
        h, w = orig["img"].shape[:2]
        dev = self.device
        verts = fit["verts"][i][None]                       # (1, V, 3) posed
        faces = pred["faces"]
        tex = pred["tex"][i][None]
        pp = np.asarray(batch["pp"][i], np.float64)
        foc = np.asarray(batch["foc"][i], np.float64)
        ppn = torch.tensor([[pp[0] / (w / 2.0) - 1.0, pp[1] / (h / 2.0) - 1.0]],
                           dtype=torch.float32, device=dev)
        focn = torch.tensor([[foc[0] / (w / 2.0), foc[1] / (h / 2.0)]],
                            dtype=torch.float32, device=dev)
        proj = G.project_ndc(verts, ppn, focn, flip_y=True)
        rast = torch.cat([proj[..., :2], proj[..., 2:] + EYE_OFFSET], -1)
        fv = rast[:, faces]
        tex_f = tex[:, faces]
        out = render_fused(fv, tex_f, tex_f, h, gamma_t=1e-4)
        alpha = out["alpha1"][0]

        def panel(img01):  # (h, h, 3) in [0, 1] -> (h, w, 3) uint8
            x = F.interpolate(img01.permute(2, 0, 1)[None], size=(h, w),
                              mode="bilinear", align_corners=False)
            return to_u8(x[0].permute(1, 2, 0).cpu().numpy())

        panels = {}
        if "tex" in want:
            panels["tex"] = panel(out["tex"][0] + (1.0 - alpha[..., None]))
        if "mask" in want:
            panels["mask"] = panel(alpha[..., None].expand(-1, -1, 3))
        if "depth" in want:
            vert_f = verts[:, faces]
            outz = render_fused(fv, vert_f, vert_f, h, gamma_t=1e-4)
            z = outz["tex"][0, :, :, 2]
            fg = alpha > 0
            if bool(fg.any()):
                z = torch.where(fg, z, z[fg].max() * 1.1)
            lo, hi = z.min(), z.max()
            z01 = (z - lo) / torch.clamp(hi - lo, min=1e-9)
            panels["depth"] = panel(z01[..., None].expand(-1, -1, 3))
        return panels
