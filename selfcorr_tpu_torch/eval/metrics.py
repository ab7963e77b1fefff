"""Pose and CUB metrics on the host (counterpart of
selfcorr_tpu/eval/metrics.py): the exact 3D IoU of the native C++ clipper
(eval/box3d_native.py), for y-symmetric categories the best over 18
rotations of the GT about its y axis; degree / cm errors; the CUB mask IoU
and keypoint transfer through the dense match fields."""
from __future__ import annotations

import numpy as np
import torch

from selfcorr_tpu_torch.eval import box3d_native as native
from selfcorr_tpu_torch.eval.box3d import Box3D
from selfcorr_tpu_torch.ops.image_ops import grid_sample


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def best_iou(symmetry_idx: int, box_pred: Box3D, rot_gt, trans_gt, scale_gt,
             division: int = 18) -> float:
    """Exact IoU; y-symmetric categories (symmetry_idx 0) take the best
    over `division` rotations of the GT about its own y axis."""
    if symmetry_idx == 0:
        y_axis = rot_gt[:, 1].copy()
        cands = np.stack([Box3D.from_transformation(
            _axis_angle_matrix(y_axis, i * 2 * np.pi / division) @ rot_gt,
            trans_gt, scale_gt).vertices for i in range(division)])
        return native.iou_max(box_pred.vertices, cands)
    return native.iou(box_pred.vertices, Box3D.from_transformation(
        rot_gt, trans_gt, scale_gt).vertices)


def deg_cm_error(symmetry_idx: int, box_pred: Box3D, rot_gt, trans_gt,
                 scale_gt):
    """(angle deg, translation cm). Translation error uses the box center;
    y-symmetric categories compare only the y axes."""
    trans_error = 100.0 * np.linalg.norm(box_pred.vertices[0] - trans_gt)
    if symmetry_idx == 0:
        box_gt = Box3D.from_transformation(rot_gt, trans_gt, scale_gt)
        y_gt = box_gt.vertices[3] - box_gt.vertices[1]
        y_pred = box_pred.vertices[3] - box_pred.vertices[1]
        cosang = y_pred @ y_gt / (np.linalg.norm(y_pred)
                                  * np.linalg.norm(y_gt))
        angle = np.arccos(np.clip(cosang, -1.0, 1.0))
    else:
        R = box_pred.rotation @ rot_gt.T
        angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
    return float(np.degrees(angle)), float(trans_error)


class NocsAccumulator:
    """IoU@{0.25, 0.5} and {5, 10} deg x {2, 5} cm bucket accuracy."""
    IOU_THRESH = (0.25, 0.5)
    DEG_CM = ((5, 2), (5, 5), (10, 2), (10, 5))
    KEYS = ("iou@25", "iou@50", "5deg2cm", "5deg5cm", "10deg2cm", "10deg5cm")

    def __init__(self, symmetry_idx: int):
        self.symmetry_idx = symmetry_idx
        self.iou_hits = []
        self.degcm_hits = []
        self.raw = []  # (iou, deg, cm) per sample

    def add(self, bbox9_pred: np.ndarray, rot_gt, trans_gt, scale_gt):
        box_pred = Box3D(bbox9_pred)
        iou = best_iou(self.symmetry_idx, box_pred, rot_gt, trans_gt,
                       scale_gt)
        ang, cm = deg_cm_error(self.symmetry_idx, box_pred, rot_gt, trans_gt,
                               scale_gt)
        self.iou_hits.append([iou >= t for t in self.IOU_THRESH])
        self.degcm_hits.append([(ang < d and cm < c) for d, c in self.DEG_CM])
        self.raw.append([float(iou), float(ang), float(cm)])

    def summary(self) -> dict:
        hits = np.concatenate([np.asarray(self.iou_hits, np.float64),
                               np.asarray(self.degcm_hits, np.float64)],
                              axis=1) if self.raw else np.zeros((0, 6))
        raw = np.asarray(self.raw, np.float64).reshape(-1, 3)
        out = {k: float(hits[:, i].mean()) if len(hits) else 0.0
               for i, k in enumerate(self.KEYS)}
        for i, k in enumerate(("median_iou", "median_deg", "median_cm")):
            out[k] = float(np.median(raw[:, i])) if len(raw) else 0.0
        out["count"] = len(raw)
        return out


def rotation_spread(rots) -> float:
    """How far rotations (N, 3, 3) spread: the median angle (degrees) to
    their chordal mean, the SVD projection of their average onto the
    rotations. A rotation head that answers one pose whatever the image
    reads near 0 (ROADMAP C.17)."""
    rots = np.asarray(rots, np.float64)
    u, _, vt = np.linalg.svd(rots.mean(0))
    mean = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    cos = (np.einsum("ij,nij->n", mean, rots) - 1.0) / 2.0
    return float(np.median(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))))


def mask_iou(mask_gt: np.ndarray, mask_pred: np.ndarray) -> np.ndarray:
    """(B, H, W) -> (B,) intersection over union."""
    inter = (mask_gt * mask_pred).sum(axis=(1, 2))
    union = (mask_gt + mask_pred - mask_gt * mask_pred).sum(axis=(1, 2))
    return inter / np.maximum(union, 1e-9)


def map_kp(kps_vis1, kps_vis2, kps1, kps2, match1, match2, mask1, mask2):
    """Keypoint transfer through the dense canonical-coordinate fields:
    each keypoint of image 1 takes its match1 value (bilinear,
    align_corners=False) and goes to the pixel of image 2 whose match2 value
    is nearest, among mask2's pixels.

    kps* (B, K, 3): xy in [-1, 1] and visibility; match* (B, H, W, 3);
    masks (B, H, W). Returns (transfer (B, K, 2) in [-1, 1), error (B, K)
    against kps2, min_dist (B, K), kp_mask (B, K))."""
    b = kps1.shape[0]
    h, w = match2.shape[1:3]
    kp_mask = kps_vis1 * kps_vis2
    kps1_3d = grid_sample(torch.as_tensor(np.asarray(match1, np.float32)),
                          torch.as_tensor(np.asarray(kps1[..., :2],
                                                     np.float32))).numpy()
    m2 = match2.reshape(b, h * w, 3)
    d = np.linalg.norm(kps1_3d[:, :, None, :] - m2[:, None, :, :], axis=-1)
    d = d + (1.0 - mask2.reshape(b, 1, h * w)) * 1000.0
    min_idx = d.argmin(axis=2)
    min_dist = np.take_along_axis(d, min_idx[..., None], 2)[..., 0]
    min_dist = min_dist + (1.0 - kps_vis1) * 1000.0
    tx = (min_idx % w).astype(np.float64) * 2 / w - 1
    ty = (min_idx // w).astype(np.float64) * 2 / h - 1
    transfer = np.stack([tx, ty], axis=-1)
    err = np.linalg.norm(transfer - kps2[..., :2], axis=-1)
    return transfer, err, min_dist, kp_mask
