"""Synthetic video dataset: ray-traced textured ellipsoids with
ground-truth poses (the port's own copy of the SyntheticVideos /
SyntheticTest part of selfcorr_tpu/data/synthetic.py), and the duo shape's
prior mesh (duo_prior_mesh).

Each 'video' is one ellipsoid instance (random per-axis radii, procedural
texture) under a smoothly varying rotation; frames provide RGB, mask, metric
depth (mm) and intrinsics. Frames are deterministic per (video, frame)
given the seed, so both packages see the same data.
"""
from __future__ import annotations

import numpy as np

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.crops import crop_frame


def duo_prior_mesh(subdivide: int = 2):
    """The shape prior of shape='duo': two merged icospheres with the duo
    family's mean proportions (radius r = 0.75, the small lobe of radius
    r * 0.5 centred r * 1.1 along +x), in the ray tracer's object frame, so
    the learned canonical frame is identifiable. Returns (verts float64
    (V, 3), faces int64 (F, 3))."""
    from selfcorr_tpu_torch.ops.mesh_ops import icosphere
    v, f = icosphere(subdivide)
    r = 0.75
    small = v * (r * 0.5) + np.array([r * 1.1, 0.0, 0.0])
    verts = np.concatenate([v * r, small]).astype(np.float64)
    faces = np.concatenate([f, f + len(v)]).astype(np.int64)
    return verts, faces


def _rot_y(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_x(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


class SyntheticVideos:
    """shape='ellipsoid': one ellipsoid per video. shape='duo': a big +
    small ellipsoid union offset along +x (rotationally unambiguous).
    shape='mix': even videos duo, odd videos a coincident two-lobe union
    (a plain ellipsoid), so every video has two parts."""

    def __init__(self, num_videos: int = 4, frames_per_video: int = 24,
                 raw_size: int = 320, seed: int = 0,
                 shape: str = "ellipsoid"):
        self.n_videos = num_videos
        self.n_frames = frames_per_video
        self.raw = raw_size
        self.shape = shape
        rng = np.random.RandomState(seed)
        self.radii = rng.uniform(0.5, 1.0, size=(num_videos, 3))
        self.phase = rng.uniform(0, 2 * np.pi, size=(num_videos,))
        self.tilt = rng.uniform(-0.4, 0.4, size=(num_videos,))
        self.z0 = rng.uniform(4.0, 6.0, size=(num_videos,))
        # duo: a second, smaller lobe offset along +x (per-video constant
        # proportions so all videos share one category-canonical layout)
        self.radii2 = self.radii * 0.5
        self.off = self.radii[:, 0] * 1.1
        if shape == "mix":
            odd = np.arange(num_videos) % 2 == 1
            self.radii2[odd] = self.radii[odd]
            self.off[odd] = 0.0

    def parts(self, vid: int):
        """[(radii, center_obj)] of the union in the object frame."""
        if self.shape == "ellipsoid":
            return [(self.radii[vid], np.zeros(3))]
        return [(self.radii[vid], np.zeros(3)),
                (self.radii2[vid], np.array([self.off[vid], 0.0, 0.0]))]

    def canonical_box(self, vid: int):
        """(center_obj (3,), size (3,)) of the union's object-frame box."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for r, cb in self.parts(vid):
            lo = np.minimum(lo, cb - r)
            hi = np.maximum(hi, cb + r)
        return (lo + hi) / 2.0, hi - lo

    def render_frame(self, vid: int, fid: int):
        """Cached: frames are deterministic per (vid, fid) and the ray trace
        costs ~50 ms."""
        key = (vid, fid)
        cache = getattr(self, "_cache", None)
        if cache is None:
            cache = self._cache = {}
        if key not in cache:
            cache[key] = self._render_frame_impl(vid, fid)
        return cache[key]

    def _render_frame_impl(self, vid: int, fid: int):
        """Ray-traced ellipsoid union: img [0,1], mask, depth, foc, pp."""
        s = self.raw
        theta = self.phase[vid] + 2 * np.pi * fid / self.n_frames
        R = _rot_x(self.tilt[vid]) @ _rot_y(theta)
        z0 = self.z0[vid]
        f_pix = s * 1.2
        foc = np.array([f_pix, f_pix], np.float32)
        pp = np.array([s / 2, s / 2], np.float32)

        ys, xs = np.meshgrid(np.arange(s) + 0.5, np.arange(s) + 0.5,
                             indexing="ij")
        # camera rays
        dx = (xs - pp[0]) / foc[0]
        dy = (ys - pp[1]) / foc[1]
        d = np.stack([dx, dy, np.ones_like(dx)], -1)  # (s,s,3)

        c = np.array([0.0, 0.0, z0])
        t_best = np.full(xs.shape, np.inf)
        hit = np.zeros(xs.shape, bool)
        for r, cb in self.parts(vid):
            # ellipsoid: |A (R^T (p - c_world))| = 1, A = diag(1/r),
            # c_world = R cb + c (cb is the lobe center in the object frame)
            cw = cb @ R.T + c
            M = np.diag(1.0 / r) @ R.T
            dm = d @ M.T
            om = (-cw) @ M.T
            a = np.sum(dm * dm, -1)
            b = 2 * np.sum(dm * om, -1)
            cc = np.sum(om * om) - 1.0
            disc = b * b - 4 * a * cc
            h = disc > 0
            t = np.where(h, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                         np.inf)
            t_best = np.minimum(t_best, t)
            hit |= h
        t = np.where(hit, t_best, 0.0)
        # depth maps are in MILLIMETERS like Wild6D/NOCS (-depth.png); GT
        # translations/sizes stay metric — the pose fit converts with x0.001
        # (tester.py:391-393)
        depth = np.where(hit, t * 1000.0, 0.0).astype(np.float32)

        # surface point in object frame -> procedural texture (normalized by
        # the union box so the pattern is asymmetric for 'duo')
        p = d * t[..., None] - c
        obj = p @ R  # R^T p as row vectors
        cb0, size = self.canonical_box(vid)
        u = (obj - cb0) / (size / 2.0)
        tex_r = 0.5 + 0.5 * np.sin(6 * u[..., 0] + 2 * u[..., 2])
        tex_g = 0.5 + 0.5 * np.sin(5 * u[..., 1] - 3 * u[..., 0])
        tex_b = 0.5 + 0.5 * np.cos(4 * u[..., 2] + u[..., 1])
        shade = 0.4 + 0.6 * np.clip(-u[..., 2], 0, 1)
        img = np.stack([tex_r, tex_g, tex_b], -1) * shade[..., None]
        img = np.where(hit[..., None], img, 0.05).astype(np.float32)
        return img, hit, depth, foc, pp


class SyntheticTest:
    """Eval analogue with ground-truth poses (column-acting R, metric units):
    the ellipsoid's canonical frame is its radii box, so rot_gt = R,
    trans_gt = center, scale_gt = 2 * radii."""

    def __init__(self, cfg: Config, num_videos: int = 2,
                 frames_per_video: int = 6, seed: int = 0,
                 shape: str = "ellipsoid"):
        self.cfg = cfg
        self.videos = SyntheticVideos(num_videos, frames_per_video, seed=seed,
                                      shape=shape)
        self.samples = [(v, f) for v in range(num_videos)
                        for f in range(0, frames_per_video,
                                       max(cfg.dframe_eval, 1))]

    def __len__(self):
        return len(self.samples)

    def read_original(self, vid: int, fid: int):
        """Full (uncropped) rendered frame for visualization paste-back."""
        img, mask, depth, _, _ = self.videos.render_frame(vid, fid)
        return dict(img=img, mask=mask.astype(np.float32), depth=depth)

    def load_item(self, index: int):
        cfg = self.cfg
        vid, fid = self.samples[index]
        img, mask, depth, foc, pp = self.videos.render_frame(vid, fid)
        out = crop_frame(img, mask, depth if cfg.use_depth else None,
                         foc, pp, cfg.img_size, np.array([1.35, 1.35]))
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        out["occ"] = np.zeros_like(out["mask"])
        if cfg.eval:
            theta = self.videos.phase[vid] + 2 * np.pi * fid / self.videos.n_frames
            R = _rot_x(self.videos.tilt[vid]) @ _rot_y(theta)
            cb0, size = self.videos.canonical_box(vid)
            out["rot_gt"] = R.astype(np.float32)
            out["trans_gt"] = (R @ cb0 + np.array(
                [0, 0, self.videos.z0[vid]])).astype(np.float32)
            out["scale_gt"] = size.astype(np.float32)
        return out


class SyntheticTrain:
    """Training analogue of the Wild6D reader over the procedural videos
    (counterpart of SyntheticTrain, selfcorr_tpu/data/synthetic.py:207).

    sample_plan draws, for each of cfg.batch_size videos, cfg.repeat frames
    spread over the video (video-major, frame-minor: the pairing layout)
    and each frame's crop scale, all from one RandomState in plan order, so
    a run's batches do not depend on the loader's thread timing; with
    num_shards blocks of that, one a rank, shard-major."""

    def __init__(self, cfg: Config, seed: int = 0, num_videos: int = 4,
                 frames_per_video: int = 24, shape: str = "ellipsoid",
                 num_shards: int = 1):
        self.cfg = cfg
        self.num_shards = num_shards
        self.videos = SyntheticVideos(num_videos, frames_per_video,
                                      seed=seed, shape=shape)
        self.rng = np.random.RandomState(seed + 1)

    def sample_plan(self, step: int):
        """[(vid, fid, crop scale (2,))] for one batch."""
        cfg = self.cfg
        plan = []
        n = self.videos.n_frames
        gap = max(n // cfg.repeat, 1)
        for _ in range(self.num_shards):
            for vid in self.rng.randint(0, self.videos.n_videos,
                                        size=cfg.batch_size):
                for i in range(cfg.repeat):
                    fid = min(gap * i + self.rng.randint(0, gap), n - 1)
                    plan.append((int(vid), int(fid),
                                 self.rng.uniform(1.2, 1.5, size=(2,))))
        return plan

    def load_item(self, vid: int, fid: int, scale):
        cfg = self.cfg
        img, mask, depth, foc, pp = self.videos.render_frame(vid, fid)
        out = crop_frame(img, mask, depth if cfg.use_depth else None,
                         foc, pp, cfg.img_size, scale)
        out["idx"] = np.int32(vid)
        out["frame_idx"] = np.int32(fid)
        out["occ"] = np.zeros_like(out["mask"])
        return out
