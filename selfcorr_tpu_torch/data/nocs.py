"""NOCS REAL275, train and test, on the host (counterpart of
selfcorr_tpu/data/nocs.py).

A 'video' is one object instance of cfg.category tracked through the
frames of a scene: each frame's `*_meta.txt` lists (instance id, class id,
model name), and the instance is followed by its model name. Labels come
from `*_label.pkl` (rotation, translation, scale, 2D box per instance).
Crops are taken around the labelled box, not the mask. `occ` marks the
pixels of other objects (raw mask neither this instance nor 255). The
intrinsics are REAL275's, floored to integers as the reference does.

Test split: the GT rotation is flipped by diag(1, -1, -1) on the right, and
the metric size is the model's extent (obj_models/real_test.pkl, beside the
test root) times the label's scale, or the scale on every axis when the
file or the model is missing. Training draws each frame's crop scale
U(1.1, 1.3) in sample_plan, in plan order.
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.crops import (crop_intrinsics, crop_resize,
                                           to_ndc_intrinsics)
from selfcorr_tpu_torch.utils.imageio import (read_gray, read_rgb,
                                              read_unchanged)

CATEGORY_IDS = {"bottle": 1, "bowl": 2, "camera": 3, "can": 4, "laptop": 5,
                "mug": 6}
REAL275_FOC = np.array([591.0125, 590.16775], np.float32)
REAL275_PP = np.array([322.525, 244.11084], np.float32)
# the reference truncates the intrinsics to integers
REAL275_FOC_INT = np.floor(REAL275_FOC).astype(np.float32)
REAL275_PP_INT = np.floor(REAL275_PP).astype(np.float32)


def _index_instances(root: str, scene_names, category: str):
    """The tracks of `category`'s instances through the listed scenes
    (indices into the sorted scene directory)."""
    cat_id = CATEGORY_IDS[category]
    scene_list = sorted(os.listdir(root))
    tracks = []
    for seq in scene_names:
        scene = scene_list[int(seq)]
        masks = glob.glob(os.path.join(root, scene, "*_mask.png"))
        masks.sort(key=lambda p: int(os.path.basename(p).split("_")[0]))
        per_obj: dict = {}
        for frame, mask_fn in enumerate(masks):
            with open(mask_fn.replace("_mask.png", "_meta.txt")) as f:
                for ln in f.read().strip().split("\n"):
                    parts = ln.split()
                    if int(parts[1]) == cat_id:
                        per_obj.setdefault(parts[2], []).append(
                            (frame, int(parts[0])))
        for obj_name, occurrences in per_obj.items():
            track = dict(name=obj_name, masks=[], metas=[])
            for frame, inst_id in occurrences:
                mask_fn = masks[frame]
                with open(mask_fn.replace("_mask.png", "_label.pkl"),
                          "rb") as f:
                    data = pickle.load(f)
                iid = list(data["instance_ids"]).index(inst_id)
                track["masks"].append(mask_fn)
                track["metas"].append(dict(
                    rotation=np.array(data["rotations"][iid]),
                    translation=np.array(data["translations"][iid]),
                    scale=np.array(data["scales"][iid]),
                    bbox=np.array(data["bboxes"][iid]),
                    model=data["model_list"][iid],
                    inst_id=inst_id))
            track["imgs"] = [m.replace("_mask.png", "_color.png")
                             for m in track["masks"]]
            track["depths"] = [m.replace("_mask.png", "_depth.png")
                               for m in track["masks"]]
            tracks.append(track)
    return tracks


def _read(track, fid: int, use_depth: bool):
    """img (H, W, 3) in [0, 1], the raw instance mask (H, W) uint8, depth
    (H, W) float32 mm or None."""
    img = read_rgb(track["imgs"][fid])
    mask_raw = read_gray(track["masks"][fid])
    depth = (read_unchanged(track["depths"][fid]).astype(np.float32)
             if use_depth else None)
    return img, mask_raw, depth


def _load_frame(track, fid: int, cfg: Config, rand_scale):
    img, mask_raw, depth = _read(track, fid, cfg.use_depth)
    meta = track["metas"][fid]
    inst = meta["inst_id"]
    occ = ((mask_raw != inst) & (mask_raw != 255)).astype(np.float32)
    mask = (mask_raw == inst).astype(np.float32)

    bbox = meta["bbox"]  # (y0, x0, y1, x1)
    center = np.array([int((bbox[1] + bbox[3]) / 2),
                       int((bbox[0] + bbox[2]) / 2)], np.int64)
    length = np.array([int((bbox[3] - bbox[1]) / 2),
                       int((bbox[2] - bbox[0]) / 2)], np.int64)
    length = np.maximum(np.array([int(rand_scale[0] * length[0]),
                                  int(rand_scale[1] * length[1])]), 1)

    s = cfg.img_size
    out = dict(
        img=crop_resize(img, center, length, s, "bilinear"),
        mask=crop_resize(mask, center, length, s, "nearest"),
        occ=crop_resize(occ, center, length, s, "nearest"),
        depth=(crop_resize(depth, center, length, s, "nearest")
               if depth is not None else np.zeros((s, s), np.float32)),
        center=center.astype(np.float32), length=length.astype(np.float32),
        foc=REAL275_FOC_INT, pp=REAL275_PP_INT)
    foc_crop, pp_crop = crop_intrinsics(REAL275_FOC_INT, REAL275_PP_INT,
                                        center, length, s)
    out["foc_crop"], out["pp_crop"] = to_ndc_intrinsics(foc_crop, pp_crop, s)
    return out


class NOCSTrain:
    def __init__(self, cfg: Config, seed: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.num_shards = num_shards
        with open(cfg.train_list) as f:
            scenes = f.read().strip().split()
        self.tracks = _index_instances(cfg.dataset_path, scenes, cfg.category)
        self.rng = np.random.RandomState(seed)

    def sample_plan(self, step: int):
        """[(vid, fid, crop scale (2,))], shard-major, video-major,
        frame-minor."""
        cfg = self.cfg
        plan = []
        for _ in range(self.num_shards):
            for vid in self.rng.randint(0, len(self.tracks),
                                        size=cfg.batch_size):
                n = len(self.tracks[int(vid)]["masks"])
                gap = max(n // cfg.repeat, 1)
                for i in range(cfg.repeat):
                    fid = min(gap * i + self.rng.randint(0, gap), n - 1)
                    plan.append((int(vid), int(fid),
                                 self.rng.uniform(1.1, 1.3, size=(2,))))
        return plan

    def load_item(self, vid: int, fid: int, scale):
        out = _load_frame(self.tracks[vid], fid, self.cfg, scale)
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        return out


class NOCSTest:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        with open(cfg.test_list) as f:
            scenes = f.read().strip().split()
        self.tracks = _index_instances(cfg.test_dataset_path, scenes,
                                       cfg.category)
        self.extents = self._load_extents()
        self.samples = [(vid, fid) for vid in range(len(self.tracks))
                        for fid in range(0, len(self.tracks[vid]["masks"]),
                                         cfg.dframe_eval)]

    def _load_extents(self):
        path = os.path.join(os.path.dirname(
            self.cfg.test_dataset_path.rstrip("/")), "obj_models",
            "real_test.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            models = pickle.load(f)
        return {k: np.asarray(v).max(0) - np.asarray(v).min(0)
                for k, v in models.items()}

    def __len__(self):
        return len(self.samples)

    def read_original(self, vid: int, fid: int):
        """The full frame and the instance's mask, for the panels."""
        track = self.tracks[vid]
        img, mask_raw, depth = _read(track, fid, self.cfg.use_depth)
        mask = (mask_raw == track["metas"][fid]["inst_id"]).astype(np.float32)
        return dict(img=img, mask=mask, depth=depth)

    def load_item(self, index: int):
        vid, fid = self.samples[index]
        out = _load_frame(self.tracks[vid], fid, self.cfg,
                          np.array([1.2, 1.2]))
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        meta = self.tracks[vid]["metas"][fid]
        if self.cfg.eval:
            rot = meta["rotation"] @ np.diag([1.0, -1.0, -1.0])
            if self.extents is not None and meta["model"] in self.extents:
                size = self.extents[meta["model"]] * meta["scale"]
            else:
                size = np.ones(3) * np.asarray(meta["scale"]).reshape(-1)[0]
            out["rot_gt"] = rot.astype(np.float32)
            out["trans_gt"] = np.asarray(
                meta["translation"], np.float32).reshape(-1)
            out["scale_gt"] = np.asarray(size, np.float32).reshape(-1)
        return out
