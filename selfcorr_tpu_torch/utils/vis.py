"""Prediction and training panels on the host, in numpy without cv2
(counterpart of selfcorr_tpu/utils/vis.py): projected 3D boxes, match /
imatch overlays, confidence, depth, texture and mask panels, the CUB
keypoint panels, and the point-set panels of the trainer's image log.

Every function takes numpy arrays (images (H, W, 3) float in [0, 1], one
sample) and returns uint8 RGB images: the port keeps RGB in memory, and the
PNGs it writes (utils/imageio.write_png) decode to the JAX package's files,
which cv2 writes from BGR. Colours are RGB here.

cv2's drawing, re-done in numpy: lines 2 pixels wide or more (cv2.line,
LINE_8: the segment clipped to the image grown by its width, cv2's polygon
scan with its sub-pixel outline, round caps); filled circles (the pixels
within the radius, as cv2.circle draws them); the JET and VIRIDIS
colormaps as cv2's own tables; cv2's 8-bit HSV to RGB conversion; bilinear
resizing of uint8 panels (cv2.resize INTER_LINEAR, within one level: cv2
rounds its weights to 11 bits).
"""
from __future__ import annotations

import os

import numpy as np

from selfcorr_tpu_torch.data.crops import linear_taps
from selfcorr_tpu_torch.utils.imageio import to_u8, write_png

# 3D box corner connectivity (center + 8 corners, z-fastest order, see
# eval/box3d.UNIT_CORNERS): the 12 edges of the cuboid
BOX_EDGES = [
    (1, 2), (1, 3), (2, 4), (3, 4),   # x = min face
    (5, 6), (5, 7), (6, 8), (7, 8),   # x = max face
    (1, 5), (2, 6), (3, 7), (4, 8),   # connecting edges
]

RED, GREEN, BLUE = (255, 0, 0), (0, 255, 0), (0, 0, 255)

# ---------------------------------------------------------------------------
# colormaps: cv2's 256-entry tables, RGB
# ---------------------------------------------------------------------------


def _jet_table() -> np.ndarray:
    """cv2.COLORMAP_JET: each channel ramps by 4 levels an entry, up from
    its start and down to its end, clipped to [0, 255] (red 95.5 / 287,
    green 32 / 223, blue -32 / 159.5); cv2's table has blue 1, not 2, at
    entry 159."""
    i = np.arange(256, dtype=np.float64)
    ramps = [np.minimum(4 * (i - up), 4 * (down - i))
             for up, down in ((95.5, 287.0), (32.0, 223.0), (-32.0, 159.5))]
    table = np.clip(np.stack(ramps, -1), 0, 255).astype(np.uint8)
    table[159, 2] = 1
    return table


# cv2.COLORMAP_VIRIDIS, RGB, 256 x 3 bytes in hex
_VIRIDIS_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725")

JET = _jet_table()
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(256, 3)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 HSV (hue in [0, 180)) -> uint8 RGB, as
    cv2.cvtColor(COLOR_HSV2BGR) converts a row of fewer than 32 pixels
    (cv2 5's per-pixel path: float32 sectors, 1 - s f fused into one
    rounding, rounded to nearest; its vector path over longer rows
    truncates instead); channels reversed."""
    f32 = np.float32
    hsv = np.asarray(hsv, np.uint8)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    f = h - sector

    def fused(frac):            # v * (1 - s frac), 1 - s frac rounded once
        return v * (1.0 - s.astype(np.float64) * frac).astype(f32)

    tab = np.stack([v, v * (f32(1.0) - s), fused(f), fused(f32(1.0) - f)],
                   -1)
    # per sector, the tab entries of (b, g, r)
    pick = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])[sector.astype(np.int64) % 6]
    bgr = np.take_along_axis(tab, pick, -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.rint(bgr * f32(255.0)), 0, 255).astype(
        np.uint8)[..., ::-1]


# ---------------------------------------------------------------------------
# drawing: cv2.line / cv2.circle at LINE_8, in place on (H, W, 3) uint8
# ---------------------------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, p1, p2):
    """cv2.clipLine of the segment p1 p2 to a (w, h) image: the ends that
    lie outside moved onto its border, or None when it misses the image.
    Integer coordinates, in pixels or in 1/65536 pixels (w, h scaled
    alike)."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _tdiv(num: int, den: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(num) // abs(den)
    return q if (num >= 0) == (den > 0) else -q


def _put(img, x: int, y: int, color):
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _subpixel_line(img, p1, p2, color):
    """cv2's Line2: the walk between two points in 1/65536 pixels along
    the major axis, one pixel a step, which outlines a thick line's
    polygon."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    half = _XY_ONE >> 1
    steep = abs(y2 - y1) >= abs(x2 - x1)
    if (y2 < y1) if steep else (x2 < x1):
        x1, y1, x2, y2 = x2, y2, x1, y1
    _put(img, (x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT, color)
    if steep:
        x_step = _tdiv((x2 - x1) << _XY_SHIFT, (y2 - y1) | 1)
        x, y = x1 + half, (y1 + half) >> _XY_SHIFT
        for _ in range(((y2 - y1) >> _XY_SHIFT) + 1):
            _put(img, x >> _XY_SHIFT, y, color)
            x += x_step
            y += 1
    else:
        y_step = _tdiv((y2 - y1) << _XY_SHIFT, (x2 - x1) | 1)
        x, y = (x1 + half) >> _XY_SHIFT, y1 + half
        for _ in range(((x2 - x1) >> _XY_SHIFT) + 1):
            _put(img, x, y >> _XY_SHIFT, color)
            x += 1
            y += y_step


def _fill_convex(img, pts, color):
    """cv2's FillConvexPoly scan of a convex polygon with vertices in
    1/65536 pixel units (its edges walked from the top vertex, spans from
    the left edge to the right one rounded to pixels, both ends in)."""
    h, w = img.shape[:2]
    n = len(pts)
    half = _XY_ONE >> 1
    for k in range(n):
        _subpixel_line(img, pts[k - 1], pts[k], color)
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))
    xmin = (min(p[0] for p in pts) + half) >> _XY_SHIFT
    xmax = (max(p[0] for p in pts) + half) >> _XY_SHIFT
    ymin = (min(ys) + half) >> _XY_SHIFT
    ymax = (max(ys) + half) >> _XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    edge = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-_XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + half) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        e["ye"] = ty
                        e["dx"] = _tdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            lo, hi = sorted((edge[0]["x"], edge[1]["x"]))
            x1 = (lo + half) >> _XY_SHIFT
            x2 = (hi + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0): min(x2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def draw_circle(img, center, radius: int, color):
    """A filled cv2.circle (thickness -1, LINE_8): the pixels within
    `radius` of `center`. In place; returns img."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
    if x0 >= x1 or y0 >= y1:
        return img
    yy, xx = np.mgrid[y0:y1, x0:x1]
    inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius * radius
    img[y0:y1, x0:x1][inside] = color
    return img


def draw_line(img, p1, p2, color, thickness: int = 2):
    """cv2.line at LINE_8, 2 pixels wide or more, between integer points:
    the segment clipped to the image grown by `thickness` on each side,
    then its rectangle of that width (cv2's polygon scan) with a filled
    circle at each end. In place; returns img."""
    if thickness < 2:
        raise ValueError("draw_line draws lines 2 pixels wide or more")
    h, w = img.shape[:2]
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t,
                         (int(p1[0]) + t, int(p1[1]) + t),
                         (int(p2[0]) + t, int(p2[1]) + t))
    if clipped is None:
        return img
    p1, p2 = [(x - t, y - t) for x, y in clipped]
    dx, dy = float(p1[0] - p2[0]), float(p2[1] - p1[1])
    r2 = dx * dx + dy * dy
    half = thickness << (_XY_SHIFT - 1)
    if r2 > 2.220446049250313e-16:
        r = (half + (thickness & 1) * _XY_ONE * 0.5) / np.sqrt(r2)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        a = (p1[0] << _XY_SHIFT, p1[1] << _XY_SHIFT)
        b = (p2[0] << _XY_SHIFT, p2[1] << _XY_SHIFT)
        _fill_convex(img, [(a[0] + ox, a[1] + oy), (a[0] - ox, a[1] - oy),
                           (b[0] - ox, b[1] - oy), (b[0] + ox, b[1] + oy)],
                     color)
    cap = (half + (_XY_ONE >> 1)) >> _XY_SHIFT
    for p in (p1, p2):
        draw_circle(img, p, cap, color)
    return img


# ---------------------------------------------------------------------------
# panels
# ---------------------------------------------------------------------------


def project_points(pts_cam: np.ndarray, pp: np.ndarray, foc: np.ndarray,
                   img_size: int) -> np.ndarray:
    """(N, 3) camera-space -> (N, 2) pixel coords (NDC intrinsics)."""
    z = np.maximum(pts_cam[:, 2], 1e-6)
    x = pp[0] + pts_cam[:, 0] * foc[0] / z
    y = pp[1] + pts_cam[:, 1] * foc[1] / z
    return (np.stack([x, y], -1) + 1.0) * (img_size / 2.0)


def draw_bbox3d(img01: np.ndarray, bbox9_cam: np.ndarray, pp, foc,
                color=GREEN) -> np.ndarray:
    """The projected oriented 3D box (bbox9 in camera space) over the crop:
    its 12 edges 2 pixels wide and a red dot at its centre."""
    s = img01.shape[0]
    out = to_u8(img01)
    pts = project_points(np.asarray(bbox9_cam), np.asarray(pp),
                         np.asarray(foc), s).astype(int)
    for a, b in BOX_EDGES:
        draw_line(out, pts[a], pts[b], color, 2)
    return draw_circle(out, pts[0], 3, RED)


def colorize_canonical(coords: np.ndarray, ranges=None) -> np.ndarray:
    """Canonical xyz -> rgb in [0, 1] by min-max normalization per axis;
    `ranges` = (lo, hi) normalizes with an external box (pred_v's extents
    for match / match_gt)."""
    c = np.asarray(coords, np.float64)
    if ranges is None:
        flat = c.reshape(-1, 3)
        lo = flat.min(0)
        hi = flat.max(0)
    else:
        lo, hi = np.asarray(ranges[0]), np.asarray(ranges[1])
    out = (c - lo) / np.maximum(hi - lo, 1e-9)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def kp_colormap(n: int) -> np.ndarray:
    """(n, 3) uint8 distinct RGB colours, one per keypoint index: an HSV
    wheel, saturation and value alternating so that neighbours stay
    apart."""
    k = np.arange(n)
    hsv = np.stack([k * 180 // max(n, 1), np.where(k % 2 == 0, 255, 160),
                    np.where(k % 3 == 0, 255, 200)], -1).astype(np.uint8)
    return hsv_to_rgb_u8(hsv)


def draw_kp(img1_01: np.ndarray, img2_01: np.ndarray, kps1: np.ndarray,
            kps2: np.ndarray, trans_kps2: np.ndarray, kp_mask: np.ndarray):
    """CUB keypoint-transfer panels: (source image + source keypoints,
    target image + the TRANSFERRED keypoints, target image + its own), the
    reference's `_1 / _2 / _2_gt` triple. Keypoint xy in [-1, 1]; one
    filled dot per keypoint visible in both, coloured by its index."""
    h, w = img1_01.shape[:2]
    colors = kp_colormap(kps1.shape[0])

    def to_pix(kps):
        return np.stack([(kps[:, 0] * 0.5 + 0.5) * w,
                         (kps[:, 1] * 0.5 + 0.5) * h], -1).astype(int)

    p1, p2, pt = to_pix(kps1), to_pix(kps2), to_pix(trans_kps2)
    out1, out2, outt = to_u8(img1_01), to_u8(img2_01), to_u8(img2_01)
    for i in range(kps1.shape[0]):
        if kp_mask[i] <= 0:
            continue
        draw_circle(out1, p1[i], 3, colors[i])
        draw_circle(out2, p2[i], 3, colors[i])
        draw_circle(outt, pt[i], 3, colors[i])
    return out1, outt, out2


def draw_match(img01: np.ndarray, match: np.ndarray, mask: np.ndarray,
               ranges=None) -> np.ndarray:
    """Per-pixel canonical-coordinate colours on the object, the image at
    0.3 elsewhere."""
    rgb = colorize_canonical(match, ranges)
    return to_u8(np.where(mask[..., None] > 0, rgb, img01 * 0.3))


def draw_imatch(img01: np.ndarray, imatch: np.ndarray, pred_v: np.ndarray,
                weight: np.ndarray | None = None) -> np.ndarray:
    """Vertex match points coloured by canonical position."""
    s = img01.shape[0]
    out = to_u8(img01)
    colors = to_u8(colorize_canonical(pred_v))
    pts = ((np.asarray(imatch) + 1.0) * (s / 2.0)).astype(int)
    for i, p in enumerate(pts):
        if weight is not None and weight[i] < 0.5:
            continue
        draw_circle(out, p, 2, colors[i])
    return out


def draw_conf(conf: np.ndarray) -> np.ndarray:
    return JET[to_u8(conf)]


def draw_depth(depth: np.ndarray, mask: np.ndarray | None = None
               ) -> np.ndarray:
    d = np.asarray(depth, np.float64).copy()
    if mask is not None and (mask > 0).any():
        d[mask <= 0] = d[mask > 0].max()
    lo, hi = d.min(), d.max()
    return VIRIDIS[to_u8((d - lo) / max(hi - lo, 1e-9))]


def draw_mask(mask: np.ndarray) -> np.ndarray:
    return to_u8(np.repeat(np.asarray(mask)[..., None], 3, -1))


def draw_point_set(points: np.ndarray, colors_u8: np.ndarray,
                   weights: np.ndarray | None = None, size: int = 256,
                   base: np.ndarray | None = None, blend: float = 0.0
                   ) -> np.ndarray:
    """Dots of radius 3 at NDC points on a white canvas (or `base` blended
    in with `blend`), RGB colours per point, skipping weight < 0.5: the
    reference's point panels."""
    canvas = np.full((size, size, 3), 255.0)
    if base is not None:
        canvas = (1.0 - blend) * canvas + blend * to_u8(base).astype(float)
    canvas = canvas.astype(np.uint8)
    pts = ((np.asarray(points) + 1.0) * (size / 2.0)).astype(int)
    for i, p in enumerate(pts):
        if weights is not None and weights[i] < 0.5:
            continue
        draw_circle(canvas, p, 3, colors_u8[i])
    return canvas


def grid_point_colors(points_ndc: np.ndarray,
                      order: str = "cycle") -> np.ndarray:
    """The reference's colours of the cycle / DINO point panels at
    127 v + 128, RGB: order='cycle' (the rotation-cycle panels) RGB = (x,
    y, 0); order='pt' (the DINO pt_src / pt_tgt / pt_pred panels) RGB =
    (0, y, x)."""
    p = np.asarray(points_ndc)
    x = np.clip(p[:, 0] * 127 + 128, 0, 255)
    y = np.clip(p[:, 1] * 127 + 128, 0, 255)
    zero = np.zeros_like(x)
    chans = [x, y, zero] if order == "cycle" else [zero, y, x]
    return np.stack(chans, -1).astype(np.uint8)


def project_pix(pts_cam: np.ndarray, pp: np.ndarray, foc: np.ndarray
                ) -> np.ndarray:
    """(N, 3) camera-space -> (N, 2) FULL-IMAGE pixel coords with
    pixel-unit intrinsics."""
    p = np.asarray(pts_cam, np.float64)
    z = np.where(np.abs(p[:, 2]) < 1e-9, 1e-9, p[:, 2])
    return np.stack([pp[0] + p[:, 0] * foc[0] / z,
                     pp[1] + p[:, 1] * foc[1] / z], -1)


def bbox_dir_points(bbox9: np.ndarray) -> np.ndarray:
    """(4, 3) [center, x, y, z] axis-indicator points: face centres pulled
    to the smallest half extent."""
    b = np.asarray(bbox9, np.float64)
    cc = b[0]
    xx = b[[2, 4, 6, 8]].mean(0) - cc
    yy = b[[1, 2, 5, 6]].mean(0) - cc
    zz = b[[5, 6, 7, 8]].mean(0) - cc
    lens = [np.linalg.norm(v) for v in (xx, yy, zz)]
    d = min(lens)
    pts = [cc]
    for v, ln in zip((xx, yy, zz), lens):
        pts.append(v / max(ln, 1e-9) * d + cc)
    return np.stack(pts, 0)


def _draw_box_edges_at(img: np.ndarray, pts2d: np.ndarray, color=RED,
                       width: int = 2) -> np.ndarray:
    """The layered box at 2D points: the ground face at 0.3 of `color`,
    the pillars at 0.6, the top at full colour. In place; returns img."""
    pts = np.int32(pts2d)
    cg = tuple(int(c * 0.3) for c in color)
    cp = tuple(int(c * 0.6) for c in color)
    for i, j in zip([3, 4, 8, 7], [4, 8, 7, 3]):
        draw_line(img, pts[i], pts[j], cg, width)
    for i, j in zip([1, 2, 5, 6], [3, 4, 7, 8]):
        draw_line(img, pts[i], pts[j], cp, width)
    for i, j in zip([1, 2, 6, 5], [2, 6, 5, 1]):
        draw_line(img, pts[i], pts[j], color, width)
    return img


def draw_bboxes_pix(img: np.ndarray, bbox9: np.ndarray, pp, foc,
                    color=RED, width: int = 3,
                    with_dirs: bool = True) -> np.ndarray:
    """The reference's draw_bboxes on the ORIGINAL frame: the layered box
    (_draw_box_edges_at) and x / y / z axis lines in red, green and blue.
    In place; returns img."""
    pts = project_pix(bbox9, np.asarray(pp), np.asarray(foc))
    _draw_box_edges_at(img, pts, color, width)
    if with_dirs:
        dp = np.int32(project_pix(bbox_dir_points(bbox9), np.asarray(pp),
                                  np.asarray(foc)))
        for k, c in zip((1, 2, 3), (RED, GREEN, BLUE)):
            draw_line(img, dp[0], dp[k], c, width)
    return img


def crop_box_pix(center, length, w: int, h: int):
    """Crop box [x1, x2, y1, y2] clipped to the frame, plus the amount
    clipped on each side."""
    cx, cy = int(round(float(center[0]))), int(round(float(center[1])))
    lx, ly = int(round(float(length[0]))), int(round(float(length[1])))
    x1, x2, y1, y2 = cx - lx, cx + lx, cy - ly, cy + ly
    clip_l = max(0, -x1)
    clip_r = max(0, x2 - (w - 1))
    clip_t = max(0, -y1)
    clip_b = max(0, y2 - (h - 1))
    return (max(x1, 0), min(x2, w - 1), max(y1, 0), min(y2, h - 1),
            clip_l, clip_r, clip_t, clip_b)


def resize_linear_u8(img: np.ndarray, width: int, height: int
                     ) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, half-pixel bilinear
    with replicated borders (cv2.resize INTER_LINEAR), rounded."""
    x0, x1, fx = linear_taps(img.shape[1], width)
    y0, y1, fy = linear_taps(img.shape[0], height)
    a = img.astype(np.float32)
    fx, fy = fx[None, :, None], fy[:, None, None]
    rows = a[:, x0] * (1 - fx) + a[:, x1] * fx
    out = rows[y0] * (1 - fy) + rows[y1] * fy
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def paste_crop_panel(frame: np.ndarray, panel: np.ndarray, center, length,
                     mask_orig: np.ndarray | None = None, mix: float = 0.7,
                     dim: float = 1.0) -> np.ndarray:
    """Paste a crop-space panel back into the original frame: resize to
    the (2 lx, 2 ly) crop box, clip at the frame's edges, alpha-blend with
    `mix`, then (with mask_orig) keep the blend only on the object and dim
    the rest."""
    h, w = frame.shape[:2]
    out = frame.astype(np.float64).copy()
    lx = max(int(round(float(length[0]))), 1)
    ly = max(int(round(float(length[1]))), 1)
    pan = resize_linear_u8(panel, 2 * lx, 2 * ly).astype(np.float64)
    x1, x2, y1, y2, cl, cr, ct, cb = crop_box_pix(center, length, w, h)
    if x2 <= x1 or y2 <= y1:
        return frame
    pan = pan[ct: 2 * ly - cb, cl: 2 * lx - cr]
    pan = pan[: y2 - y1, : x2 - x1]
    out[y1: y1 + pan.shape[0], x1: x1 + pan.shape[1]] = \
        out[y1: y1 + pan.shape[0], x1: x1 + pan.shape[1]] * (1 - mix) \
        + pan * mix
    if mask_orig is not None:
        m = np.asarray(mask_orig, np.float64)
        if m.ndim == 2:
            m = m[..., None]
        out = out * m + frame.astype(np.float64) * (1 - m) * dim
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_depth_diff(depth_diff: np.ndarray) -> np.ndarray:
    """Signed depth error: red where the estimate is too near
    (diff < 0), green where too far."""
    d = np.asarray(depth_diff, np.float64)
    scale = max(np.abs(d).max(), 1e-9)
    red = np.clip(-d / scale, 0, 1)
    green = np.clip(d / scale, 0, 1)
    return to_u8(np.stack([red, green, np.zeros_like(d)], -1))


def train_panels(batch: dict, v: dict, cfg) -> dict:
    """The trainer's image panels, tag -> uint8 RGB: the reference's
    channels (img, mask, depth_render, depth_mean_v_render, depth_gt,
    depth_diff_render, match, match_gt, texture_render, imatch, imatch_gt,
    depthw, cycle_match (+gt), pt_src / tgt / pred, pt_img_src / tgt) and
    mask_render, of frame 0 (and 1 for the pairs). batch: numpy frames 0
    and 1 of one video, float; v: forward_vis's products in numpy."""
    img0, img1, mask0 = batch["img"][0], batch["img"][1], batch["mask"][0]
    pv = v["pred_v"][0]
    ranges = (pv.min(0), pv.max(0))
    s = cfg.img_size
    out = {
        "vis/img": to_u8(img0),
        "vis/mask": draw_mask(mask0),
        "vis/match": draw_match(img0, v["match"][0], mask0, ranges),
        "vis/match_gt": draw_match(img0, v["match_gt"][0],
                                   v["match_mask"][0] > 0.5, ranges),
        "vis/texture_render": to_u8(v["tex_render"][0]),
        "vis/mask_render": draw_mask(v["mask_render"][0]),
        "vis/depth_render": draw_depth(v["depth_render"][0],
                                       v["depth_mask"][0]),
        "vis/depth_mean_v_render": draw_depth(v["mean_v_depth"][0],
                                              v["mean_v_mask"][0]),
    }
    if cfg.use_depth:
        out["vis/depth_gt"] = draw_depth(batch["depth"][0], mask0)
        out["vis/depth_diff_render"] = draw_depth_diff(v["depth_diff"][0])
    # vertex panels, visibility-gated
    vcol = to_u8(colorize_canonical(pv))
    dw = v["depth_weight"][0]
    out["vis/imatch"] = draw_point_set(v["imatch"][0], vcol, dw, s)
    out["vis/imatch_gt"] = draw_point_set(v["imatch_gt"][0], vcol, dw, s)
    gray = np.repeat((dw[:, None] * 255).astype(np.uint8), 3, 1)
    out["vis/depthw"] = draw_point_set(v["imatch_gt"][0], gray, None, s,
                                       base=img0, blend=1.0)
    # rotation-cycle panels
    ccol = grid_point_colors(v["cycle_match_gt"][0])
    cm = v["cycle_mask"][0]
    out["vis/cycle_match"] = draw_point_set(v["cycle_match"][0], ccol, cm, s)
    out["vis/cycle_match_gt"] = draw_point_set(v["cycle_match_gt"][0], ccol,
                                               cm, s)
    # frozen-DINO pair panels
    pcol = grid_point_colors(v["pt_pts_tgt"][0], order="pt")
    pm = v["pt_mask"][0]
    out["vis/pt_img_src"] = to_u8(img0)
    out["vis/pt_img_tgt"] = to_u8(img1)
    out["vis/pt_src"] = draw_point_set(v["pt_pts_src"][0], pcol, pm, s,
                                       base=img0, blend=0.3)
    out["vis/pt_tgt"] = draw_point_set(v["pt_pts_tgt"][0], pcol, pm, s,
                                       base=img1, blend=0.3)
    out["vis/pt_pred"] = draw_point_set(v["pt_match"][0], pcol, pm, s)
    return out


PANEL_FLAGS = ("visualize_bbox", "visualize_match", "visualize_imatch",
               "visualize_conf", "visualize_depth", "visualize_mask",
               "visualize_tex", "visualize_mesh", "visualize_gt")


def panels_on(cfg):
    """flag -> whether its panel is drawn: the --visualize_* flags given,
    or every panel when none is (plain --vis_pred)."""
    any_specific = any(getattr(cfg, f) for f in PANEL_FLAGS)
    return lambda flag: (not any_specific) or getattr(cfg, flag)


def save_visualizations(out_dir: str, tag: str, batch, pred, fit, index: int,
                        cfg, orig=None, renders=None) -> None:
    """Write the enabled panels of sample `index` as
    out_dir/<tag>_<panel>.png (and <tag>_mesh.obj, <tag>_3d.png).

    orig: optional dict(img=(H, W, 3) float01 RGB, mask=(H, W) float,
    depth=(H, W) | None), the ORIGINAL full-resolution frame. With it, the
    panels are pasted back into it through the crop box (center / length
    of the batch), as the reference's figures are; without it they draw
    on the crop. renders: optional dict of full-frame uint8 RGB render
    panels ('depth' / 'tex' / 'mask'), the Tester's re-rendered fitted
    mesh. pred / fit hold numpy arrays."""
    from selfcorr_tpu_torch.eval.box3d import Box3D
    from selfcorr_tpu_torch.ops.mesh_ops import save_obj
    os.makedirs(out_dir, exist_ok=True)
    i = index
    img = np.asarray(batch["img"][i])
    mask = np.asarray(batch["mask"][i])
    pp_c = np.asarray(batch["pp_crop"][i])
    foc_c = np.asarray(batch["foc_crop"][i])

    def put(name, im):
        write_png(os.path.join(out_dir, f"{tag}_{name}.png"), im)

    on = panels_on(cfg)
    pred_v = np.asarray(pred["pred_v"][i])
    ranges = (pred_v.min(0), pred_v.max(0))   # the box of the colourings
    bbox9 = np.asarray(fit["bbox9"][i]) if fit is not None else None
    box_gt = None
    if on("visualize_gt") and "rot_gt" in batch:
        # GT oriented box (NOCS convention: column-acting R, metric units)
        box_gt = Box3D.from_transformation(
            np.asarray(batch["rot_gt"][i]), np.asarray(batch["trans_gt"][i]),
            np.asarray(batch["scale_gt"][i])).vertices

    if orig is not None:
        mask_orig = orig.get("mask")
        pp_f = np.asarray(batch["pp"][i])      # full-image pixel intrinsics
        foc_f = np.asarray(batch["foc"][i])
        center = np.asarray(batch["center"][i])
        length = np.asarray(batch["length"][i])
        frame = to_u8(np.asarray(orig["img"]))

        put("img", frame)
        if bbox9 is not None and on("visualize_bbox"):
            put("bbox", draw_bboxes_pix(frame.copy(), bbox9, pp_f, foc_f))
        if on("visualize_match"):
            # crop-space canonical colours pasted into the frame, blended
            # at 0.7 and masked to the object
            panel = to_u8(colorize_canonical(np.asarray(pred["match"][i]),
                                             ranges))
            out = paste_crop_panel(frame, panel, center, length,
                                   mask_orig=mask_orig, mix=0.7, dim=1.0)
            if bbox9 is not None and cfg.match_with_bbox:
                out = draw_bboxes_pix(out, bbox9, pp_f, foc_f)
            put("match", out)
        if on("visualize_imatch"):
            # vertex match points in frame coordinates through the crop box
            out = frame.copy()
            x1 = center[0] - length[0]
            y1 = center[1] - length[1]
            pts = np.asarray(pred["imatch"][i], np.float64)
            px = (pts[:, 0] + 1) * length[0] + x1
            py = (pts[:, 1] + 1) * length[1] + y1
            cols = to_u8(colorize_canonical(pred_v, ranges))
            for vi in range(pts.shape[0]):
                draw_circle(out, (int(px[vi]), int(py[vi])), 4, cols[vi])
            put("imatch", out)
        if box_gt is not None:
            put("gt", draw_bboxes_pix(frame.copy(), box_gt, pp_f, foc_f,
                                      color=GREEN))
            if bbox9 is not None:
                save_bboxes_3d(os.path.join(out_dir, f"{tag}_3d.png"),
                               [bbox9, box_gt])
            if orig.get("depth") is not None:
                put("depth_gt", draw_depth(np.asarray(orig["depth"])))
        for name in ("depth", "tex", "mask"):
            if renders is not None and name in renders \
                    and on(f"visualize_{name}"):
                put(name, renders[name])
        if pred.get("match_conf") is not None and on("visualize_conf"):
            put("conf", draw_conf(np.asarray(pred["match_conf"][i])))
        if on("visualize_mesh"):
            save_obj(os.path.join(out_dir, f"{tag}_mesh.obj"), pred_v,
                     np.asarray(pred["faces"]))
        return

    # ---- crop space (no original frame) ----
    put("img", to_u8(img))
    if bbox9 is not None and on("visualize_bbox"):
        put("bbox", draw_bbox3d(img, bbox9, pp_c, foc_c))
    if on("visualize_match"):
        out_m = draw_match(img, np.asarray(pred["match"][i]), mask)
        if bbox9 is not None and cfg.match_with_bbox:
            pts = project_points(bbox9, pp_c, foc_c, img.shape[0])
            out_m = _draw_box_edges_at(out_m, pts)
        put("match", out_m)
    if on("visualize_imatch"):
        put("imatch", draw_imatch(img, np.asarray(pred["imatch"][i]),
                                  pred_v))
    if pred.get("match_conf") is not None and on("visualize_conf"):
        put("conf", draw_conf(np.asarray(pred["match_conf"][i])))
    if "depth" in batch and on("visualize_depth"):
        put("depth", draw_depth(np.asarray(batch["depth"][i]), mask))
    if on("visualize_mask"):
        put("mask", draw_mask(mask))
    if renders is not None and "tex" in renders and on("visualize_tex"):
        put("tex", renders["tex"])
    if box_gt is not None:
        put("bbox_gt", draw_bbox3d(img, box_gt, pp_c, foc_c, color=BLUE))
    if on("visualize_mesh"):
        save_obj(os.path.join(out_dir, f"{tag}_mesh.obj"), pred_v,
                 np.asarray(pred["faces"]))


def save_bboxes_3d(path: str, boxes, alpha: float = 30, beta: float = 12
                   ) -> None:
    """Matplotlib 3D figure of 9-corner boxes (predicted, GT) with the 12
    cuboid edges; nothing without matplotlib, as in the JAX package."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    colors = ["r", "b", "g", "k"]
    for i, b in enumerate(boxes):
        b = np.asarray(b)
        ax.scatter(b[:, 0], b[:, 1], b[:, 2], c="r")
        for e0, e1 in BOX_EDGES:
            ax.plot(b[[e0, e1], 0], b[[e0, e1], 1], b[[e0, e1], 2],
                    linewidth=2, c=colors[i % len(colors)])
    ax.view_init(alpha, beta)
    plt.savefig(path)
    plt.close(fig)
