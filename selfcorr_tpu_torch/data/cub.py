"""CUB-200-2011 birds, train and test (counterpart of
selfcorr_tpu/data/cub.py; reference data/dataset_cub.py, UCMR-style).

Annotations: `<cache>/data/{split}_cub_cleaned.mat` (bbox, mask, 15
keypoints) and `<cache>/sfm/anno_{split}.mat` (SfM scale, translation,
rotation), read with scipy.io.loadmat. A 'video' is one bird class and its
images are the 'frames'. The crop: the box padded by 0.2 of its size (and
jittered by up to 0.05 in training), made square, cut out with a zero
background and resized to img_size (bilinear image, nearest mask, cv2's
semantics, data/crops.resize). Pseudo intrinsics f = 2 max(H, W), pp the
image centre. Keypoints go to [-1, 1] with their visibility; the SfM pose
is exported as (scale, translation (2,), WXYZ quaternion).

Training draws each item's four box jitters U[0, 1) in sample_plan, in plan
order; the test split draws nothing (its jitter is 0).
"""
from __future__ import annotations

import os

import numpy as np
import scipy.io as sio

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.crops import (crop_intrinsics, resize,
                                           to_ndc_intrinsics)
from selfcorr_tpu_torch.utils.imageio import read_rgb

NO_JITTER = np.zeros(4)


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """A float32 rotation matrix (3, 3) -> WXYZ quaternion with w >= 0, in
    numpy: the reader imports no torch, so a loader's worker process does
    not pay for it. Bit for bit ops/geometry.matrix_to_quat (Shepperd: of
    the four candidates, the one whose diagonal term is largest)."""
    m = np.asarray(R, np.float32)
    one = np.float32(1.0)
    diag = np.array([one + m[0, 0] + m[1, 1] + m[2, 2],
                     one + m[0, 0] - m[1, 1] - m[2, 2],
                     one - m[0, 0] + m[1, 1] - m[2, 2],
                     one - m[0, 0] - m[1, 1] + m[2, 2]], np.float32)
    cand = np.array([
        [diag[0], m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
        [m[2, 1] - m[1, 2], diag[1], m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]],
        [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], diag[2], m[1, 2] + m[2, 1]],
        [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], diag[3]],
    ], np.float32)
    q = cand[int(np.argmax(diag))]
    q = q / np.maximum(np.sqrt(np.sum(q * q)), np.float32(1e-12))
    return q if q[0] >= 0 else -q


def _peturb_bbox(bbox, pf: float, jf: float, draws):
    """Pad each side of (x0, y0, x1, y1) by pf of the box's size, moved by
    (1 - 2 draw) jf of it; draws (4,) in [0, 1)."""
    b = [float(c) for c in bbox]
    bw = b[2] - b[0] + 1
    bh = b[3] - b[1] + 1
    b[0] -= pf * bw + (1 - 2 * draws[0]) * jf * bw
    b[1] -= pf * bh + (1 - 2 * draws[1]) * jf * bh
    b[2] += pf * bw + (1 - 2 * draws[2]) * jf * bw
    b[3] += pf * bh + (1 - 2 * draws[3]) * jf * bh
    return b


def _square_bbox(bbox):
    b = [int(round(c)) for c in bbox]
    bw = b[2] - b[0] + 1
    bh = b[3] - b[1] + 1
    maxdim = float(max(bw, bh))
    b[0] -= int(round((maxdim - bw) / 2.0))
    b[1] -= int(round((maxdim - bh) / 2.0))
    b[2] = int(b[0] + maxdim - 1)
    b[3] = int(b[1] + maxdim - 1)
    return b


def _crop(img, bbox, bgval: float = 0.0):
    """The box's pixels (inclusive corners), `bgval` outside the image."""
    b = [int(round(c)) for c in bbox]
    bw = b[2] - b[0] + 1
    bh = b[3] - b[1] + 1
    out = np.full((bh, bw) + img.shape[2:], bgval, np.float32)
    h, w = img.shape[:2]
    x0, x1 = max(0, b[0]), min(w, b[2] + 1)
    y0, y1 = max(0, b[1]), min(h, b[3] + 1)
    out[y0 - b[1]: y1 - b[1], x0 - b[0]: x1 - b[0]] = img[y0:y1, x0:x1]
    return out


class _CUBBase:
    def __init__(self, cfg: Config, split: str, seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.rng = np.random.RandomState(seed)
        root = cfg.dataset_path if split == "train" else cfg.test_dataset_path
        if cfg.dataset_cache_path:
            cache = cfg.dataset_cache_path
        elif os.path.isdir(os.path.join(root, "cachedir")):
            cache = os.path.join(root, "cachedir", "cub")
        else:
            cache = root
        self.img_dir = os.path.join(root, "images")
        self.anno = sio.loadmat(
            os.path.join(cache, "data", f"{split}_cub_cleaned.mat"),
            struct_as_record=False, squeeze_me=True)["images"]
        self.anno_sfm = sio.loadmat(
            os.path.join(cache, "sfm", f"anno_{split}.mat"),
            struct_as_record=False, squeeze_me=True)["sfm_anno"]

        with open(os.path.join(root, "classes.txt")) as f:
            cls_data = f.read().strip().split()
        name_to_id = {cls_data[2 * i + 1]: int(cls_data[2 * i])
                      for i in range(len(cls_data) // 2)}
        per_class: dict = {}
        for idx in range(len(self.anno)):
            cname = str(self.anno[idx].rel_path).split("/")[0]
            per_class.setdefault(name_to_id[cname] - 1, []).append(idx)

        list_file = cfg.train_list if split == "train" else cfg.test_list
        with open(list_file) as f:
            class_ids = [int(x) for x in f.read().strip().split()]
        self.class_groups = [per_class.get(c, []) for c in class_ids]

    def _load(self, index: int, jitter: float, draws):
        cfg = self.cfg
        data = self.anno[index]
        sfm = self.anno_sfm[index]
        img = read_rgb(os.path.join(self.img_dir, str(data.rel_path)))
        mask = np.asarray(data.mask, np.float32)
        bbox = np.array([data.bbox.x1, data.bbox.y1, data.bbox.x2,
                         data.bbox.y2], float) - 1
        kp = np.asarray(data.parts.T, np.float64).copy()
        vis = kp[:, 2] > 0
        kp[vis, :2] -= 1

        quat = matrix_to_quat(sfm.rot)
        s_sfm = float(sfm.scale)
        t_sfm = np.asarray(sfm.trans, np.float64).copy()

        bbox = _square_bbox(_peturb_bbox(bbox, 0.2, jitter, draws))
        x0, y0 = bbox[0], bbox[1]

        h, w = img.shape[:2]
        foc = np.array([2.0 * max(h, w)] * 2, np.float32)
        pp = np.array([w // 2, h // 2], np.float32)
        center = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
        length = np.maximum(np.array([(bbox[2] - bbox[0]) / 2,
                                      (bbox[3] - bbox[1]) / 2]), 1)

        img_c = _crop(img, bbox)
        mask_c = _crop(mask, bbox)
        kp[vis, 0] = np.clip(kp[vis, 0] - x0, 0, bbox[2] - bbox[0])
        kp[vis, 1] = np.clip(kp[vis, 1] - y0, 0, bbox[3] - bbox[1])
        t_sfm[0] -= x0
        t_sfm[1] -= y0

        S = cfg.img_size
        scale = S / float(max(img_c.shape[:2]))
        img_c = resize(img_c, S, "bilinear")
        mask_c = resize(mask_c, S, "nearest")
        kp[vis, :2] *= scale
        s_sfm *= scale
        t_sfm *= scale

        # keypoints and pose to [-1, 1] (reference dataset_cub.py:289-302)
        kp_norm = np.stack([2 * kp[:, 0] / S - 1, 2 * kp[:, 1] / S - 1,
                            kp[:, 2]], -1) * (kp[:, 2:] > 0)
        s_sfm *= (1.0 / S + 1.0 / S)
        t_norm = np.array([2 * t_sfm[0] / S - 1, 2 * t_sfm[1] / S - 1])

        foc_crop, pp_crop = crop_intrinsics(foc, pp, center, length, S)
        foc_ndc, pp_ndc = to_ndc_intrinsics(foc_crop, pp_crop, S)
        return dict(
            img=img_c.astype(np.float32),
            mask=(mask_c > 0.5).astype(np.float32),
            depth=np.zeros((S, S), np.float32),
            occ=np.zeros((S, S), np.float32),
            center=center.astype(np.float32), length=length.astype(np.float32),
            foc=foc, pp=pp, foc_crop=foc_ndc, pp_crop=pp_ndc,
            kp=kp_norm.astype(np.float32),
            sfm_pose=np.concatenate([[s_sfm], t_norm, quat]).astype(
                np.float32))


class CUBTrain(_CUBBase):
    def __init__(self, cfg: Config, seed: int = 0, num_shards: int = 1):
        super().__init__(cfg, "train", seed)
        self.num_shards = num_shards

    def sample_plan(self, step: int):
        """[(vid, fid, box jitter draws (4,))], shard-major, video-major,
        frame-minor."""
        cfg = self.cfg
        plan = []
        for _ in range(self.num_shards):
            for vid in self.rng.randint(0, len(self.class_groups),
                                        size=cfg.batch_size):
                n = max(len(self.class_groups[int(vid)]), 1)
                gap = max(n // cfg.repeat, 1)
                for i in range(cfg.repeat):
                    fid = min(gap * i + self.rng.randint(0, gap), n - 1)
                    plan.append((int(vid), int(fid),
                                 self.rng.random_sample(4)))
        return plan

    def load_item(self, vid: int, fid: int, draws):
        out = self._load(self.class_groups[vid][fid], 0.05, draws)
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        return out


class CUBTest(_CUBBase):
    def __init__(self, cfg: Config):
        super().__init__(cfg, "test", cfg.seed)
        self.samples = [(vid, fid)
                        for vid, group in enumerate(self.class_groups)
                        for fid in range(0, len(group),
                                         max(cfg.dframe_eval, 1))]

    def __len__(self):
        return len(self.samples)

    def load_item(self, index: int):
        vid, fid = self.samples[index]
        out = self._load(self.class_groups[vid][fid], 0.0, NO_JITTER)
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        return out
