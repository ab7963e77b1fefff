"""The CPU mirror of the forward kernels' culls (ops/rasterizer/kernel.py
fwd_visits): B1 tests each face's padded bbox against its block and then
against each warp's sub-tile, B1' against the chunks of each tile and then
the sub-tile. A pair that a kernel skips must cover nothing, so the mirror
is held against the plain forward's own cover test (con1 or con2 of
reference._pair_geometry) at every (face, pixel) pair; and the kernels'
tile constants, parsed from their sources, against the mirror's.

The mirror of the backwards' walk (kernel.bwd_visits): B2 runs the cover
test on every pixel of each face's padded box, B2' only on those of tiles
whose cull visits the face's chunk. Held against the pairs to which the
plain backwards may give a contribution, and B2' against B2.
"""
import os
import re

import numpy as np
import pytest
import torch

from selfcorr_tpu_torch.ops.rasterizer import api, common as C, kernel
from selfcorr_tpu_torch.ops.rasterizer.chunks import (tiles_for,
                                                      visited_chunks)
from selfcorr_tpu_torch.ops.rasterizer.reference import _pair_geometry
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIGMA1, SIGMA2 = 1e-4, 1e-3
CSRC = os.path.join(os.path.dirname(kernel.SOURCES["raster_fused_fwd"]))


def scene(seed, b, nf, size=0.3, surf_res=0):
    """Random faces of up to `size` NDC; with surf_res, texels too."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.9, 0.9, (b, nf, 1, 2))
    tri = rng.uniform(-size / 2, size / 2, (b, nf, 3, 2))
    z = 5.0 + rng.uniform(-1.0, 1.0, (b, nf, 3, 1))
    fv = np.concatenate([centers + tri, z], -1).astype(np.float32)
    tex = rng.rand(b, nf, 3, 3).astype(np.float32)
    surf = (rng.rand(b, nf, surf_res ** 2, 3).astype(np.float32)
            if surf_res else None)
    return fv, tex, surf


def pack(fv, tex, s, surf=None):
    return C.pack_constants(torch.tensor(fv), torch.tensor(tex),
                            torch.tensor(tex), n_bands=C.bands_for(s),
                            surf_tex=None if surf is None
                            else torch.tensor(surf))


def covered(consts, s):
    """(B, S * S, F) bool: the pairs the plain forward counts as covered."""
    xp, yp = C.pixel_grid(s)
    px, py = xp[None, :, None], yp[None, :, None]
    g = _pair_geometry(consts, px, py, px * px + py * py, SIGMA1, SIGMA2)
    return g["contrib1"] | g["contrib2"]


def culls(consts, s):
    """The two forwards' culls at image size s: B1's, and B1''s on the
    chunk cull of the same constants."""
    return {"B1": {},
            "B1'": dict(chunks=api.chunk_info(consts, s, SIGMA1, SIGMA2))}


def visited_pair_mask(consts, s, **kw):
    """(B, S * S, F) bool, row-major pixels: the mirror's visits at each
    pixel."""
    visits = kernel.fwd_visits(consts, s, SIGMA1, SIGMA2, **kw)
    r = torch.arange(s)
    return visits[:, r // kernel.LANE_ROWS][:, :, r // kernel.SUB_COLS] \
        .reshape(visits.shape[0], s * s, -1)


def assert_keeps_covered(consts, s):
    cov = covered(consts, s)
    assert cov.any()
    for name, kw in culls(consts, s).items():
        visit = visited_pair_mask(consts, s, **kw)
        dropped = cov & ~visit
        assert not dropped.any(), (name, int(dropped.sum()))
        # a visited pair lies in its sub-tile's padded box: the visited
        # count is what the mask holds
        assert kernel.visited_pairs(consts, s, SIGMA1, SIGMA2, **kw) == \
            int(visit.sum()), name


@pytest.mark.parametrize("s,b,nf,seed", [(32, 2, 60, 0), (40, 2, 60, 1),
                                         (64, 2, 60, 2), (72, 2, 40, 5),
                                         (320, 1, 24, 3)])
def test_cull_keeps_every_covered_pair(s, b, nf, seed):
    fv, tex, _ = scene(seed, b, nf)
    assert_keeps_covered(pack(fv, tex, s), s)


def border_scene(s, rows):
    """Small faces centred on the corners and edges of sub-tiles of
    8 x `rows` pixels, some of them just across a border, and faces whose
    covered band only grazes a sub-tile."""
    fvs = []
    for c in (8, 16, 24, s // 2):
        for r in (rows, 2 * rows, s // 2 + rows):
            # the pixel border between columns c - 1, c and rows r - 1, r
            x = (2.0 * c - s) / s
            y = (s - 2.0 * r) / s
            for dx, dy, h in ((0.0, 0.0, 0.5), (0.4, -0.3, 0.2),
                              (-0.9, 0.1, 0.05), (1.5, 1.5, 0.02)):
                cx, cy = x + dx * 2.0 / s, y + dy * 2.0 / s
                hh = h * 2.0 / s
                fvs.append([[cx - hh, cy - hh, 5.0], [cx + hh, cy - hh, 5.2],
                            [cx, cy + hh, 5.1]])
    return np.asarray(fvs, np.float32)[None]


@pytest.mark.parametrize("s", [32, 64])
def test_cull_keeps_faces_straddling_sub_tile_borders(s):
    fv = border_scene(s, kernel.LANE_ROWS)
    fv = np.concatenate([fv, border_scene(s, 2 * kernel.LANE_ROWS)], 1)
    tex = np.random.RandomState(5).rand(*fv.shape).astype(np.float32)
    assert_keeps_covered(pack(fv, tex, s), s)


def test_cull_skips_off_screen_and_padding_faces():
    """Faces off screen and the inert padding faces (bbox 1e9) are visited
    nowhere; F = 21 pads to 32."""
    s = 32
    fv, tex, _ = scene(7, 2, 21)
    fv[:, :5, :, :2] += 4.0               # off screen
    consts = pack(fv, tex, s)
    assert consts.shape[1] == 32
    assert_keeps_covered(consts, s)
    order = C.face_order(torch.tensor(fv), C.bands_for(s))
    off = torch.isin(order, torch.arange(5))           # (B, 21) sorted
    for name, kw in culls(consts, s).items():
        visits = kernel.fwd_visits(consts, s, SIGMA1, SIGMA2, **kw)
        per_face = visits.any(1).any(1)                  # (B, F)
        assert not per_face[:, 21:].any(), name
        assert not (per_face[:, :21] & off).any(), name


@pytest.mark.parametrize("s", [32, 40])
def test_cull_keeps_covered_pairs_with_texels(s):
    fv, tex, surf = scene(8, 2, 40, surf_res=6)
    consts = pack(fv, tex, s, surf)
    assert consts.shape[2] == C.k_for(6)
    assert_keeps_covered(consts, s)


@pytest.mark.parametrize("s,b,nf,seed", [(32, 2, 60, 0), (64, 2, 60, 2),
                                         (256, 1, 80, 4), (320, 1, 24, 3)])
def test_visited_pairs_at_most_the_block_cull(s, b, nf, seed):
    """The warps' cull visits no more pairs than the earlier 16 x 16 block
    cull, and at least the covered ones."""
    fv, tex, _ = scene(seed, b, nf)
    consts = pack(fv, tex, s)
    old = kernel.block_cull_pairs(consts, s, SIGMA1, SIGMA2)
    n_cov = int(covered(consts, s).sum())
    for name, kw in culls(consts, s).items():
        n = kernel.visited_pairs(consts, s, SIGMA1, SIGMA2, **kw)
        assert n_cov <= n <= old, (name, n_cov, n, old)


@pytest.mark.parametrize("s", [40, 256, 320])
def test_b1_chunk_visits_b1s_pairs(s):
    """B1' runs B1's sub-tiles, so it shades the pairs B1 shades, but for
    faces the chunk cull drops on its own rounding."""
    fv, tex, _ = scene(9, 1, 40)
    consts = pack(fv, tex, s)
    chunks = api.chunk_info(consts, s, SIGMA1, SIGMA2)
    b1 = kernel.fwd_visits(consts, s, SIGMA1, SIGMA2)
    b1c = kernel.fwd_visits(consts, s, SIGMA1, SIGMA2, chunks=chunks)
    assert b1.shape == b1c.shape
    assert not (b1c & ~b1).any()
    assert int((b1 & ~b1c).sum()) <= int(b1.sum()) // 100


def live_pairs(consts, s, chunks=None):
    """(B, S * S, F) bool: the pairs to which the plain backward (with
    chunks, raster_fused_bwd_chunk_plain) may give a nonzero contribution:
    either sigma covers them, under the chunk gate."""
    gate = None
    if chunks is not None:
        f = consts.shape[1]
        gate = visited_chunks(*chunks, s, f // C.FF)[..., torch.arange(f)
                                                      // C.FF]
    xp, yp = C.pixel_grid(s)
    px, py = xp[None, :, None], yp[None, :, None]
    g = _pair_geometry(consts, px, py, px * px + py * py, SIGMA1, SIGMA2,
                       gate)
    return g["contrib1"] | g["contrib2"]


@pytest.mark.parametrize("s,surf_res", [(40, 0), (256, 0), (320, 0),
                                        (64, 6)])
def test_b2_chunk_tests_b2s_pixels_and_keeps_live_pairs(s, surf_res):
    """B2' runs B2's walk and tests a pixel only where the cull visits the
    face's chunk: every pair the chunk plain backward may count lies on a
    pixel B2' tests, B2' tests no pixel B2 does not, and the covered pixels
    it queues are exactly B2's (nothing here is culled by rounding)."""
    fv, tex, surf = scene(9, 2 if s < 256 else 1, 40, surf_res=surf_res)
    consts = pack(fv, tex, s, surf)
    chunks = api.chunk_info(consts, s, SIGMA1, SIGMA2)
    b2 = kernel.bwd_visits(consts, s, SIGMA1, SIGMA2)
    b2c = kernel.bwd_visits(consts, s, SIGMA1, SIGMA2, chunks=chunks)
    live = live_pairs(consts, s, chunks)
    live_b2 = live_pairs(consts, s)
    assert b2.shape == b2c.shape == live.shape
    assert live.any()
    assert not (live & ~b2c).any()
    assert not (b2c & ~b2).any()
    assert not (live_b2 & ~b2).any()
    assert torch.equal(live_b2 & b2c, live_b2 & b2)
    assert torch.equal(live, live_b2)


def test_b2_chunk_skips_cleared_tiles():
    """With every mask bit of some tiles cleared, B2' tests no pixel of
    those tiles, and the pairs it drops are exactly the ones the chunk
    plain backward drops there."""
    s = 64
    fv, tex, _ = scene(10, 1, 60)
    consts = pack(fv, tex, s)
    spans, masks = api.chunk_info(consts, s, SIGMA1, SIGMA2)
    tl = tiles_for(s)
    cleared = masks.reshape(1, tl.count, -1).clone()
    cleared[:, ::2] = 0                       # every other tile
    chunks = (spans, cleared.reshape(masks.shape))
    b2c = kernel.bwd_visits(consts, s, SIGMA1, SIGMA2, chunks=chunks)
    tile = torch.arange(s)[:, None] // tl.rows * tl.n_cols \
        + torch.arange(s)[None, :] // tl.cols
    off = (tile % 2 == 0).reshape(-1)
    assert b2c.any() and not b2c[:, off].any()
    live = live_pairs(consts, s, chunks)
    assert torch.equal(live, live_pairs(consts, s) & b2c)


def constant(src, name):
    m = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", src)
    assert m, name
    return eval(m.group(1), {}, {})


@pytest.mark.parametrize("name,const,mirror", [
    ("raster_common.cuh", "SUB_COLS", kernel.SUB_COLS),
    ("raster_common.cuh", "LANE_ROWS", kernel.LANE_ROWS),
    ("raster_common.cuh", "N_FIX", 60),
    ("raster_fwd.cu", "WX", kernel.FWD_BLOCK_COLS // kernel.SUB_COLS),
    ("raster_fwd.cu", "WY", kernel.FWD_BLOCK_ROWS // kernel.LANE_ROWS)])
def test_kernel_tile_constants_are_the_mirrors(name, const, mirror):
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()
    if const == "LANE_ROWS":
        assert re.search(r"constexpr int LANE_ROWS = 32 / SUB_COLS;", src)
        assert constant(src, "SUB_COLS") * mirror == 32
    else:
        assert constant(src, const) == mirror
    if name == "raster_fwd.cu":
        assert "BLOCK_COLS = WX * SUB_COLS, BLOCK_ROWS = WY * LANE_ROWS;" \
            in src


@pytest.mark.parametrize("s", [40, 72, 256, 320])
def test_chunk_tiles_hold_whole_sub_tiles(s):
    """B1' splits each tile of chunks.tiles_for into rows of LANE_ROWS
    (its launch refuses other tile heights), so its sub-tiles are B1's."""
    tl = tiles_for(s)
    assert tl.rows % kernel.LANE_ROWS == 0
    with open(os.path.join(CSRC, "raster_fwd_chunk.cu")) as f:
        src = f.read()
    assert "tile_rows != 2 * LANE_ROWS && tile_rows != 4 * LANE_ROWS" in src
    assert tl.rows in (2 * kernel.LANE_ROWS, 4 * kernel.LANE_ROWS)


def test_chunk_tiles_take_b2_chunk_shifts():
    """B2' finds a pixel's tile by shifts and stages at most MAX_TILES bits
    a face: at every S it takes (MAX_S_BWD), tiles are 8 or 16 rows and 64
    or 128 columns, or one column of S < 128 (which a shift by 7 finds),
    and there are at most MAX_TILES of them."""
    with open(os.path.join(CSRC, "raster_common.cuh")) as f:
        src = f.read()
    max_s, max_tiles = constant(src, "MAX_S_BWD"), constant(src, "MAX_TILES")
    for s in range(1, max_s + 1):
        tl = tiles_for(s)
        assert tl.rows in (8, 16), s
        assert tl.cols in (64, 128) or (tl.cols == s < 128), s
        assert tl.count <= max_tiles, s
    assert "cs = tl.cols == 64 ? 6 : 7;" in src
    assert "rs = tl.rows == 16 ? 4 : 3;" in src
