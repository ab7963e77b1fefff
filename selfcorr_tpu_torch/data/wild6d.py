"""Wild6D videos, train and test, on the host (counterpart of
selfcorr_tpu/data/wild6d.py).

Layout (reference data/dataset_wild6d.py, dataset_wild6d_test.py):
  <root>/<object>/<seq>/images/{N}.jpg, {N}-mask.png, {N}-depth.png
  <root>/<object>/<seq>/metadata          JSON: K (stored transposed), w, h
  test: <...>/test_set/pkl_annotations/<cat>/<cat>-<object>-<seq>.pkl with
  each frame's GT rotation, translation and size.

A list file names videos as `..._<object index>_<sequence index>` into the
sorted directory listings; enumerate_videos / write_list write the whole
enumeration of a root as such a list (tools/gen_lists.py is its command
line).
Training draws, per step, cfg.batch_size videos and cfg.repeat frames of
each, spread over the video, and each frame's crop scale U(1.2, 1.5) in
sample_plan, in plan order (see SyntheticTrain). Images decode through
utils/imageio (Pillow).
"""
from __future__ import annotations

import glob
import json
import os
import pickle

import numpy as np

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.crops import crop_frame
from selfcorr_tpu_torch.utils.imageio import (read_gray, read_rgb,
                                              read_unchanged)


def _subdirs(path: str):
    """Sorted directories of `path`; stray files cannot shift the index."""
    return sorted(d for d in os.listdir(path)
                  if os.path.isdir(os.path.join(path, d)))


def enumerate_videos(root: str) -> list[str]:
    """`<obj_idx>_<seq_idx>` of every <root>/<obj>/<seq> with an images/
    directory, indexing the sorted listings as Wild6DVideos resolves
    them."""
    return [f"{oi}_{si}" for oi, obj in enumerate(_subdirs(root))
            for si, seq in enumerate(_subdirs(os.path.join(root, obj)))
            if os.path.isdir(os.path.join(root, obj, seq, "images"))]


def write_list(root: str, out_path: str) -> int:
    """Write root's enumeration to out_path, one token a line; returns the
    number of videos. Raises FileNotFoundError when root holds none."""
    tokens = enumerate_videos(root)
    if not tokens:
        raise FileNotFoundError(
            f"no <object>/<sequence>/images/ videos under {root}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(tokens) + "\n")
    return len(tokens)


class Wild6DVideos:
    """Index of videos: frame paths and intrinsics."""

    def __init__(self, root: str, video_list_file: str):
        with open(video_list_file) as f:
            names = f.read().strip().split()
        obj_list = _subdirs(root)
        self.videos = []
        for name in names:
            parts = name.split("_")
            obj = obj_list[int(parts[-2])]
            seq = _subdirs(os.path.join(root, obj))[int(parts[-1])]
            seq_dir = os.path.join(root, obj, seq)
            masks = glob.glob(os.path.join(seq_dir, "images/*-mask.png"))
            masks.sort(key=lambda p: int(os.path.basename(p).split("-")[0]))
            with open(os.path.join(seq_dir, "metadata")) as f:
                meta = json.load(f)
            K = np.array(meta["K"]).reshape(3, 3).T if "K" in meta else None
            self.videos.append(dict(
                obj=obj, seq=seq, masks=masks,
                imgs=[m.replace("-mask.png", ".jpg") for m in masks],
                depths=[m.replace("-mask.png", "-depth.png") for m in masks],
                K=K))

    def __len__(self):
        return len(self.videos)

    def num_frames(self, vid: int) -> int:
        return len(self.videos[vid]["masks"])

    def read_frame(self, vid: int, fid: int, use_depth: bool):
        """img (H, W, 3) float32 in [0, 1], mask (H, W) bool, depth (H, W)
        float32 mm or None, foc (2,), pp (2,)."""
        v = self.videos[vid]
        img = read_rgb(v["imgs"][fid])
        mask = read_gray(v["masks"][fid]) > 0
        depth = (read_unchanged(v["depths"][fid]).astype(np.float32)
                 if use_depth else None)
        K = v["K"]
        foc = np.array([K[0, 0], K[1, 1]], np.float32)
        pp = np.array([K[0, 2], K[1, 2]], np.float32)
        return img, mask, depth, foc, pp


class Wild6DTrain:
    def __init__(self, cfg: Config, seed: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.num_shards = num_shards
        self.videos = Wild6DVideos(cfg.dataset_path, cfg.train_list)
        self.rng = np.random.RandomState(seed)

    def sample_plan(self, step: int):
        """[(vid, fid, crop scale (2,))], shard-major, video-major,
        frame-minor."""
        cfg = self.cfg
        plan = []
        for _ in range(self.num_shards):
            for vid in self.rng.randint(0, len(self.videos),
                                        size=cfg.batch_size):
                n = self.videos.num_frames(int(vid))
                gap = max(n // cfg.repeat, 1)
                for i in range(cfg.repeat):
                    fid = min(gap * i + self.rng.randint(0, gap), n - 1)
                    plan.append((int(vid), int(fid),
                                 self.rng.uniform(1.2, 1.5, size=(2,))))
        return plan

    def load_item(self, vid: int, fid: int, scale):
        cfg = self.cfg
        img, mask, depth, foc, pp = self.videos.read_frame(
            vid, fid, cfg.use_depth)
        out = crop_frame(img, mask, depth, foc, pp, cfg.img_size, scale,
                         no_stretch=cfg.no_stretch)
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        out["occ"] = np.zeros_like(out["mask"])
        return out


class Wild6DTest:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.videos = Wild6DVideos(cfg.test_dataset_path, cfg.test_list)
        self.gt = self._load_gt() if cfg.eval else None
        self.samples = [(vid, fid) for vid in range(len(self.videos))
                        for fid in range(0, self.videos.num_frames(vid),
                                         cfg.dframe_eval)]

    def _load_gt(self):
        """Per video, per frame {rotation, translation, size}, read from
        the pkl beside the test split, stored as given (no flip)."""
        root = self.cfg.test_dataset_path
        prefix = root.rfind("test_set") + 9
        cat = root[prefix:].strip("/")
        gt = []
        for v in self.videos.videos:
            path = os.path.join(root[:prefix], "pkl_annotations", cat,
                                f"{cat}-{v['obj']}-{v['seq']}.pkl")
            with open(path, "rb") as f:
                data = pickle.load(f)
            gt.append([dict(rotation=np.array(a["rotation"]),
                            translation=np.array(a["translation"]),
                            size=np.array(a["size"]))
                       for a in data["annotations"]])
        return gt

    def __len__(self):
        return len(self.samples)

    def read_original(self, vid: int, fid: int):
        """The full frame, for the panels."""
        img, mask, depth, _, _ = self.videos.read_frame(
            vid, fid, self.cfg.use_depth)
        return dict(img=img, mask=mask.astype(np.float32), depth=depth)

    def load_item(self, index: int):
        cfg = self.cfg
        vid, fid = self.samples[index]
        img, mask, depth, foc, pp = self.videos.read_frame(
            vid, fid, cfg.use_depth)
        out = crop_frame(img, mask, depth, foc, pp, cfg.img_size,
                         np.array([1.35, 1.35]))
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        out["occ"] = np.zeros_like(out["mask"])
        if self.gt is not None:
            g = self.gt[vid][fid]
            out["rot_gt"] = g["rotation"].astype(np.float32)
            out["trans_gt"] = g["translation"].astype(np.float32).reshape(-1)
            out["scale_gt"] = g["size"].astype(np.float32)
        return out
