"""The port's NOCS metrics against the JAX package's on the same boxes.
Both score boxes with the native C++ clipper (native/box3d_iou.cpp): the
port's binding equals the JAX package's bit for bit, and NocsAccumulator
gives the same per-sample IoU, degree and cm errors (within 1e-6) and the
same six bucket accuracies. The scipy IoU (eval/box3d.py) stays the plain
version, within 1e-3 of the clipper."""
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from selfcorr_tpu.eval import box3d_native as jax_native
from selfcorr_tpu.eval.metrics import NocsAccumulator as JaxAccumulator
from selfcorr_tpu_torch.eval import box3d_native as native
from selfcorr_tpu_torch.eval.box3d import Box3D, box_iou
from selfcorr_tpu_torch.eval.metrics import NocsAccumulator


def box_pairs(n, seed):
    """n (pred, gt) vertex pairs, from near-equal to disjoint boxes."""
    rng = np.random.RandomState(seed)
    pairs = []
    for i in range(n):
        rot = Rotation.random(random_state=rng).as_matrix()
        t = rng.uniform(-0.3, 0.3, 3)
        s = rng.uniform(0.1, 0.5, 3)
        spread = 0.6 * i / n
        rot_p = Rotation.from_rotvec(rng.randn(3) * spread).as_matrix() @ rot
        pairs.append((
            Box3D.from_transformation(rot_p, t + rng.randn(3) * spread * 0.3,
                                      s * (1 + rng.uniform(-spread, spread,
                                                           3))).vertices,
            Box3D.from_transformation(rot, t, s).vertices))
    return pairs


def test_native_iou_equals_jax_bit_for_bit():
    assert jax_native.available()
    pairs = box_pairs(50, 0)
    got = [native.iou(p, g) for p, g in pairs]
    want = [jax_native.iou(p, g) for p, g in pairs]
    assert got == want
    assert min(got) < 0.1 and max(got) > 0.9
    preds, gts = (np.stack(x) for x in zip(*pairs))
    assert native.iou_batch(preds, gts).tolist() == got
    assert native.iou_max(preds[0], gts) == jax_native.iou_max(preds[0], gts)
    assert native.iou_max(preds[0], gts) == max(
        native.iou(preds[0], g) for g in gts)
    # the plain version: scipy's hull, ~1e-4 from the clipper
    np.testing.assert_allclose([box_iou(Box3D(p), Box3D(g))
                                for p, g in pairs[:10]], got[:10],
                               atol=1e-3, rtol=0)


def test_native_iou_refuses_bad_shapes():
    with pytest.raises(ValueError, match="9, 3"):
        native.iou(np.zeros((8, 3)), np.zeros((9, 3)))
    with pytest.raises(ValueError, match="boxes against"):
        native.iou_batch(np.zeros((2, 9, 3)), np.zeros((3, 9, 3)))


@pytest.mark.parametrize("symmetry_idx", [0, -1])
def test_nocs_accumulator_matches_jax(symmetry_idx):
    assert jax_native.available()
    rng = np.random.RandomState(symmetry_idx + 10)
    ours, ref = NocsAccumulator(symmetry_idx), JaxAccumulator(symmetry_idx)
    for i in range(12):
        rot_gt = Rotation.random(random_state=rng).as_matrix()
        trans_gt = rng.uniform(-0.3, 0.3, 3) + [0.0, 0.0, 1.0]
        scale_gt = rng.uniform(0.1, 0.4, 3)
        # predictions from near-perfect to far off, so every bucket is hit
        spread = 0.02 * i
        rot_p = Rotation.from_rotvec(rng.randn(3) * spread).as_matrix() @ rot_gt
        trans_p = trans_gt + rng.randn(3) * spread * 0.5
        scale_p = scale_gt * (1.0 + rng.uniform(-spread, spread, 3))
        bbox9 = Box3D.from_transformation(rot_p, trans_p, scale_p).vertices
        ours.add(bbox9, rot_gt, trans_gt, scale_gt)
        ref.add(bbox9, rot_gt, trans_gt, scale_gt)
    np.testing.assert_allclose(np.asarray(ours.raw), np.asarray(ref.raw),
                               atol=1e-6, rtol=0)
    got, want = ours.summary(), ref.summary()
    for k in NocsAccumulator.KEYS + ("count",):
        assert got[k] == want[k], k
    assert 0.0 < got["iou@50"] < 1.0
