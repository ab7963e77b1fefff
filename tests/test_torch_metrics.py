"""The port's NOCS metrics (scipy ConvexHull IoU) against the JAX package's
NocsAccumulator on the same boxes: per-sample IoU, degree and cm errors
within 1e-6, and the same six bucket accuracies. The JAX package is held to
its scipy IoU too: its native C++ clipper differs from it by ~1e-4, and the
port has no native IoU yet."""
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from selfcorr_tpu.eval import box3d_native
from selfcorr_tpu.eval.metrics import NocsAccumulator as JaxAccumulator
from selfcorr_tpu_torch.eval.box3d import Box3D
from selfcorr_tpu_torch.eval.metrics import NocsAccumulator


@pytest.mark.parametrize("symmetry_idx", [0, -1])
def test_nocs_accumulator_matches_jax(symmetry_idx, monkeypatch):
    monkeypatch.setattr(box3d_native, "available", lambda: False)
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
