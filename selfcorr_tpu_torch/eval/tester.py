"""Evaluation driver (counterpart of selfcorr_tpu/eval/tester.py), single
device: per batch the eval forward and the whole-batch RANSAC pose fit run
on the device; the exact 3D IoU / deg-cm metrics run on the host. The
weights come from --model_path (a port checkpoint or a reference .pth),
else from --seed; the run's flags go to checkpoint_dir/name/config-test.txt.

With --vis_pred the fitted mesh is re-rendered with the original frame's
intrinsics into full-frame depth / texture / mask panels (the fused
rasterizer: the CUDA kernel on a CUDA device). A failure to read the
original frame skips its panels; a rasterizer build or launch error
propagates. The panels the JAX package draws with cv2
(--visualize_{bbox,match,imatch,conf,mesh,gt}) are not ported: asking for
one raises, as do several devices or processes (configs.refuse_unported).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from selfcorr_tpu_torch.configs import Config, refuse_unported
from selfcorr_tpu_torch.data.loader import BATCH_KEYS, TestLoader
from selfcorr_tpu_torch.eval.metrics import NocsAccumulator
from selfcorr_tpu_torch.eval.pose_fit import fit_poses
from selfcorr_tpu_torch.models.meshnet import (MeshNet, build_mesh_constants,
                                               forward_test)
from selfcorr_tpu_torch.ops import geometry as G
from selfcorr_tpu_torch.ops.image_ops import jitter_factors
from selfcorr_tpu_torch.ops.rasterizer import render_fused
from selfcorr_tpu_torch.ops.rasterizer.common import EYE_OFFSET
from selfcorr_tpu_torch.utils import checkpoint as ckpt
from selfcorr_tpu_torch.utils.device import resolve_device
from selfcorr_tpu_torch.utils.logging import write_config_snapshot
from selfcorr_tpu_torch.utils.png import to_u8, write_png
from selfcorr_tpu_torch.utils.weight_convert import load_reference_ckpt


def make_test_dataset(cfg: Config):
    if cfg.dataset_name == "synthetic":
        from selfcorr_tpu_torch.data.synthetic import SyntheticTest
        return SyntheticTest(cfg, shape=cfg.synthetic_shape)
    raise NotImplementedError(
        f"dataset {cfg.dataset_name!r}: only 'synthetic' is ported so far; "
        f"the Wild6D / NOCS / CUB readers come in a later slice")


def init_model(cfg: Config, constants) -> MeshNet:
    """MeshNet with weights initialized from cfg.seed, on the CPU (so the
    weights do not depend on the device)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return MeshNet(cfg, constants)


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


class Tester:
    __test__ = False  # not a pytest class

    def __init__(self, cfg: Config, model: MeshNet | None = None):
        refuse_unported(cfg, train=False)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        write_config_snapshot(self.run_dir, cfg, "config-test.txt")
        self.constants = build_mesh_constants(cfg)
        if model is None:
            model = init_model(cfg, self.constants)
        if cfg.model_path:
            load_model(model, cfg.model_path)
        self.model = model.to(self.device).eval()
        self.base_rot = torch.as_tensor(self.constants.base_rot,
                                        device=self.device)
        self.generator = torch.Generator().manual_seed(cfg.seed + 123)

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device)
                for k, v in batch.items() if k in BATCH_KEYS}

    def predict_batch(self, batch: dict, jitter=None, sample_idx=None):
        """Forward + pose fit of one host batch. jitter (4,) and
        sample_idx (B, ransac_iters, 5) are the draws; absent ones come
        from the Tester's generator."""
        cfg = self.cfg
        tb = self.to_device(batch)
        if jitter is None:
            jitter = jitter_factors(self.generator)
        pred = forward_test(self.model, tb, self.constants, cfg,
                            jitter=jitter)
        fit = fit_poses(pred["match"], pred["match_conf"], tb["depth"],
                        tb["mask"], tb["pp_crop"], tb["foc_crop"],
                        pred["pred_v"], self.base_rot,
                        max_points=cfg.pose_fit_max_points,
                        n_iters=cfg.ransac_iters, sample_idx=sample_idx,
                        generator=self.generator)
        return pred, fit

    def test(self) -> dict:
        cfg = self.cfg
        dataset = make_test_dataset(cfg)
        loader = TestLoader(dataset, cfg)
        acc = NocsAccumulator(cfg.symmetry_idx) if cfg.eval_nocs else None
        out_dir = cfg.vis_path or os.path.join(self.run_dir, "vis")
        try:
            for bi, batch in enumerate(loader):
                pred, fit = self.predict_batch(batch)
                valid = batch["valid"]
                if acc is not None and "rot_gt" in batch:
                    bbox9 = fit["bbox9"].cpu().numpy()
                    for i in np.flatnonzero(valid):
                        acc.add(bbox9[i], batch["rot_gt"][i],
                                batch["trans_gt"][i], batch["scale_gt"][i])
                if cfg.vis_pred:
                    self._write_panels(dataset, batch, pred, fit, out_dir)
                if (bi + 1) % 10 == 0:
                    print(f"tested batch {bi + 1}/{len(loader)}")
        finally:
            loader.close()

        results = {}
        if acc is not None:
            results = acc.summary()
            for k in NocsAccumulator.KEYS:
                print(f"{k}:", results[k])
        return results

    def _write_panels(self, dataset, batch, pred, fit, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        read_orig = getattr(dataset, "read_original", None)
        if read_orig is None:
            return
        for i in np.flatnonzero(batch["valid"]):
            vid, fid = int(batch["idx"][i]), int(batch["frame_idx"][i])
            try:
                orig = read_orig(vid, fid)
            except (OSError, KeyError, ValueError) as e:
                print(f"[vis] original frame {vid}/{fid} unavailable ({e})")
                continue
            tag = f"{vid:03d}_{fid:03d}"
            for name, panel in self._debug_panels(batch, pred, fit, i,
                                                  orig).items():
                write_png(os.path.join(out_dir, f"{tag}_{name}.png"), panel)

    def _debug_panels(self, batch, pred, fit, i, orig) -> dict:
        """Full-frame depth / texture / mask panels: the FITTED mesh
        re-rendered with the original frame's intrinsics (per-axis NDC),
        rendered at s = h and resized to (h, w): those that a
        --visualize_{depth,tex,mask} flag asks for, or all three when none
        does (the other visualize flags raise at __init__). Returns name ->
        uint8 (h, w, 3) RGB."""
        cfg = self.cfg
        want = [n for n in ("depth", "tex", "mask")
                if getattr(cfg, f"visualize_{n}")] or ["depth", "tex", "mask"]
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
