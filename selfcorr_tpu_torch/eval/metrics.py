"""NOCS-style pose metrics on the host (counterpart of
selfcorr_tpu/eval/metrics.py): exact 3D IoU with an 18-fold y-rotation sweep
for y-symmetric categories, and degree / cm errors. IoU comes from
box3d.box_iou (scipy ConvexHull); the native C++ IoU is later work."""
from __future__ import annotations

import numpy as np

from selfcorr_tpu_torch.eval.box3d import Box3D, box_iou


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
        return max(box_iou(box_pred, Box3D.from_transformation(
            _axis_angle_matrix(y_axis, i * 2 * np.pi / division) @ rot_gt,
            trans_gt, scale_gt)) for i in range(division))
    return box_iou(box_pred,
                   Box3D.from_transformation(rot_gt, trans_gt, scale_gt))


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
