"""The evaluation's full-frame panels when something fails (ROADMAP C.14),
on the CPU, through Tester.test() on the synthetic test set at the port
tests' small size.

* An original frame that cannot be read (read_original raises, as a missing
  file does): that sample's panels are drawn on the crop, every other
  sample's in its frame with the render panels, and the evaluation ends.
* A panel render that fails (B1 in _debug_panels; on the CPU its plain
  version, here made to raise): the error reaches the caller. The JAX
  package catches any Exception there ("vis must never kill eval",
  selfcorr_tpu/eval/tester.py:147-167), which on the card would hide a
  failed kernel launch.
"""
import os

import pytest

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.synthetic import SyntheticTest
from selfcorr_tpu_torch.eval import tester as T
from selfcorr_tpu_torch.utils.imageio import read_unchanged
from test_torch_slice import SMALL
from test_torch_threads import share_cores  # noqa: F401 (autouse)


def panel_cfg(tmp_path):
    """The first frame of each of the two test videos, the mask panel
    (one render a frame)."""
    return Config(device="cpu", checkpoint_dir=str(tmp_path), name="c14",
                  vis_pred=True, visualize_mask=True,
                  vis_path=str(tmp_path / "vis"),
                  **{**SMALL, "dframe_eval": 6})


def test_unreadable_frame_draws_its_panels_on_the_crop(tmp_path,
                                                       monkeypatch, capsys):
    read = SyntheticTest.read_original

    def missing_first(self, vid, fid):
        if (vid, fid) == (0, 0):
            raise FileNotFoundError(f"no frame {vid}/{fid}")
        return read(self, vid, fid)
    monkeypatch.setattr(SyntheticTest, "read_original", missing_first)
    results = T.Tester(panel_cfg(tmp_path)).test()
    assert results["count"] == 2
    assert "original frame 0/0 unavailable" in capsys.readouterr().out
    vis = tmp_path / "vis"
    pngs = sorted(f for f in os.listdir(vis) if f.endswith(".png"))
    tags = sorted({f[:7] for f in pngs})
    assert tags == ["000_000", "001_000"], pngs
    for f in pngs:
        # 000_000 on its 32 x 32 crop, the others in their 320 x 320 frames
        size = 32 if f.startswith("000_000") else 320
        assert read_unchanged(str(vis / f)).shape == (size, size, 3), f
    for tag in tags:
        assert f"{tag}_img.png" in pngs and f"{tag}_mask.png" in pngs


def test_failed_panel_render_raises(tmp_path, monkeypatch):
    def failed_launch(*args, **kwargs):
        raise RuntimeError("raster_fused_fwd launch failed: CUDA error 700")
    monkeypatch.setattr(T, "render_fused", failed_launch)
    with pytest.raises(RuntimeError, match="launch failed"):
        T.Tester(panel_cfg(tmp_path)).test()
