"""Synthetic training batches made on the device (counterpart of
selfcorr_tpu/data/synthetic_device.py, --synthetic_on_device).

The scenes are data/synthetic.py's ray-traced ellipsoid videos. Each item's
crop box comes from the ellipsoid's analytic silhouette box (the ray-hit
region of an ellipsoid is an ellipse in ray-direction space, whose extent
has a closed form), and the crop is rendered directly at img_size through
the crop's camera: no raw render, no resample. Both deviations from the
host path are the JAX package's (its module docstring).

Plain PyTorch on the device: the JAX package has no kernel here. The draws
(videos, frame offsets, crop scales) are injected as everywhere in the
port; absent, they come from a CPU torch.Generator (step_generator seeds
one from (seed + 2, step), the counterpart of fold_in(PRNGKey(seed + 2),
step)). The crop box is integer: a float that lands within an ulp of an
integer in one package and not the other moves the box by one raw pixel
(ROADMAP C.15).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data.synthetic import SyntheticVideos


def video_tables(videos: SyntheticVideos, device) -> dict:
    """Per-video scene constants as float32 tensors on `device`: part radii
    and centres (P, V, 3), phase, tilt, z0 (V,), the canonical box's centre
    and size (V, 3)."""
    v = videos.n_videos
    parts = [videos.parts(vid) for vid in range(v)]
    boxes = [videos.canonical_box(vid) for vid in range(v)]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return dict(
        radii=t([[p[i][0] for p in parts] for i in range(len(parts[0]))]),
        cents=t([[p[i][1] for p in parts] for i in range(len(parts[0]))]),
        phase=t(videos.phase), tilt=t(videos.tilt), z0=t(videos.z0),
        cb0=t([b[0] for b in boxes]), size=t([b[1] for b in boxes]))


def rot_mats(tilt, theta):
    """R = rot_x(tilt) @ rot_y(theta), (B, 3, 3)."""
    ct, st = torch.cos(tilt), torch.sin(tilt)
    cy, sy = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(ct), torch.ones_like(ct)
    rx = torch.stack([o, z, z, z, ct, -st, z, st, ct], -1).reshape(-1, 3, 3)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(-1, 3, 3)
    return rx @ ry


def part_geometry(radii, cent, rot, z0):
    """Ray-trace constants of one part of each item: M = diag(1/r) R^T,
    its centre cw = R cent + (0, 0, z0) and om = -M cw."""
    m = rot.transpose(1, 2) / radii[:, :, None]
    zero = torch.zeros_like(z0)
    cw = torch.einsum("bij,bj->bi", rot, cent) + torch.stack(
        [zero, zero, z0], -1)
    om = torch.einsum("bi,bji->bj", -cw, m)
    return m, om, cw


def part_bbox_dxdy(m, om):
    """The silhouette's extent in ray-direction (dx, dy) space: the ellipse
    e^T P e + 2 w^T e + c0 <= 0 with Q = k I - om om^T, k = |om|^2 - 1,
    P = A^T Q A, w = A^T Q m3, c0 = m3^T Q m3 (A, m3: M's columns). Returns
    (lo, hi), each (B, 2)."""
    a2 = m[:, :, :2]
    m3 = m[:, :, 2]
    k = (om * om).sum(-1) - 1.0
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    q = k[:, None, None] * eye - om[:, :, None] * om[:, None, :]
    p = torch.einsum("bij,bik,bkl->bjl", a2, q, a2)
    w = torch.einsum("bij,bik,bk->bj", a2, q, m3)
    c0 = torch.einsum("bi,bij,bj->b", m3, q, m3)
    det = p[:, 0, 0] * p[:, 1, 1] - p[:, 0, 1] * p[:, 1, 0]
    pinv = torch.stack([
        torch.stack([p[:, 1, 1], -p[:, 0, 1]], -1),
        torch.stack([-p[:, 1, 0], p[:, 0, 0]], -1)], 1) / det[:, None, None]
    ec = -torch.einsum("bij,bj->bi", pinv, w)
    s = torch.einsum("bi,bij,bj->b", w, pinv, w) - c0
    half = torch.sqrt(torch.clamp(
        torch.stack([pinv[:, 0, 0], pinv[:, 1, 1]], -1) * s[:, None], min=0))
    return ec - half, ec + half


def trace_parts(d, tables, vids, rot, z0, n_parts):
    """Ray-trace the union of the parts along rays d (B, S, S, 3): (hit,
    t, surface points in the object frame (B, S, S, 3))."""
    t_best = torch.full(d.shape[:-1], math.inf, device=d.device)
    hit = torch.zeros(d.shape[:-1], dtype=torch.bool, device=d.device)
    for i in range(n_parts):
        m, om, _ = part_geometry(tables["radii"][i][vids],
                                 tables["cents"][i][vids], rot, z0)
        dm = torch.einsum("bhwi,bji->bhwj", d, m)
        a = (dm * dm).sum(-1)
        b = 2.0 * torch.einsum("bhwi,bi->bhw", dm, om)
        cc = ((om * om).sum(-1) - 1.0)[:, None, None]
        disc = b * b - 4.0 * a * cc
        h = disc > 0
        t = torch.where(h, (-b - torch.sqrt(torch.clamp(disc, min=0)))
                        / (2.0 * a), math.inf)
        t_best = torch.minimum(t_best, t)
        hit = hit | h
    t = torch.where(hit, t_best, 0.0)
    zero = torch.zeros_like(z0)
    c = torch.stack([zero, zero, z0], -1)
    p = d * t[..., None] - c[:, None, None, :]
    return hit, t, torch.einsum("bhwi,bij->bhwj", p, rot)


def crop_bbox_analytic(tables, vids, rot, z0, raw: int, n_parts: int):
    """The union's silhouette box in raw-pixel index space, as the host's
    mask_bbox counts covered pixel centres: (centre, half length), each
    (B, 2) int32 in (x, y)."""
    foc, pp = raw * 1.2, raw / 2.0
    lo = hi = None
    for i in range(n_parts):
        m, om, _ = part_geometry(tables["radii"][i][vids],
                                 tables["cents"][i][vids], rot, z0)
        plo, phi = part_bbox_dxdy(m, om)
        lo = plo if lo is None else torch.minimum(lo, plo)
        hi = phi if hi is None else torch.maximum(hi, phi)
    # pixel centres i + 0.5 with (i + 0.5 - pp) / foc inside [lo, hi]
    imin = torch.clamp(torch.ceil(lo * foc + pp - 0.5), 0, raw - 1).int()
    imax = torch.clamp(torch.floor(hi * foc + pp - 0.5), 0, raw - 1).int()
    return (imax + imin) // 2, (imax - imin) // 2


def render_crop(tables, vids, fids, center, length, out_size: int, raw: int,
                n_frames: int, n_parts: int) -> dict:
    """Render each item through its crop's camera at out_size: img, mask,
    depth (mm), and foc_crop / pp_crop in NDC units, as
    crops.to_ndc_intrinsics gives them. center / length (B, 2) int: the
    crop box in raw pixels, already scaled."""
    theta = (tables["phase"][vids]
             + 2.0 * math.pi * fids.float() / n_frames)
    rot = rot_mats(tables["tilt"][vids], theta)
    z0 = tables["z0"][vids]
    foc, pp, s = raw * 1.2, raw / 2.0, out_size
    lf = length.float()
    cf = (s / 2.0) / lf
    foc_ndc = foc * cf / (s / 2.0)
    x0 = (center - length).float()
    pp_ndc = (pp - x0) * cf / (s / 2.0) - 1.0
    # output pixel i samples the raw coordinate x0 + (i + 0.5) (2 l / S),
    # where cv2.resize samples the crop
    idx = (torch.arange(s, dtype=torch.float32, device=lf.device) + 0.5) \
        * 2.0 / s
    xs = x0[:, 0:1] + idx[None, :] * lf[:, 0:1]
    ys = x0[:, 1:2] + idx[None, :] * lf[:, 1:2]
    dx = (xs - pp) / foc
    dy = (ys - pp) / foc
    b = dx.shape[0]
    d = torch.stack([dx[:, None, :].expand(b, s, s),
                     dy[:, :, None].expand(b, s, s),
                     torch.ones((b, s, s), device=dx.device)], -1)
    hit, t, obj = trace_parts(d, tables, vids, rot, z0, n_parts)
    depth = torch.where(hit, t * 1000.0, 0.0)
    u = (obj - tables["cb0"][vids][:, None, None, :]) \
        / (tables["size"][vids][:, None, None, :] / 2.0)
    tex_r = 0.5 + 0.5 * torch.sin(6 * u[..., 0] + 2 * u[..., 2])
    tex_g = 0.5 + 0.5 * torch.sin(5 * u[..., 1] - 3 * u[..., 0])
    tex_b = 0.5 + 0.5 * torch.cos(4 * u[..., 2] + u[..., 1])
    shade = 0.4 + 0.6 * torch.clamp(-u[..., 2], 0.0, 1.0)
    img = torch.stack([tex_r, tex_g, tex_b], -1) * shade[..., None]
    img = torch.where(hit[..., None], img, 0.05)
    return dict(img=img, mask=hit.float(), depth=depth, foc_crop=foc_ndc,
                pp_crop=pp_ndc)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The draws of step `step`'s batch in a run seeded `seed`."""
    key = np.random.SeedSequence((seed + 2, step)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


def make_device_synth(cfg: Config, videos: SyntheticVideos, device):
    """gen(generator=None, vids=None, offs=None, scale=None) -> one float32
    training batch on `device` (img, mask, depth, occ, pp_crop, foc_crop),
    video-major and frame-minor as the pairing losses read it. The draws:
    vids (batch_size,) the videos, offs (batch_size, repeat) each frame's
    offset in its stretch of the video, scale (batch_size * repeat, 2) each
    crop's scale in [1.2, 1.5); absent ones come from `generator`."""
    tables = video_tables(videos, device)
    n_parts = 1 if videos.shape == "ellipsoid" else 2
    bs, rp = cfg.batch_size, cfg.repeat
    nf, nv, raw, s = videos.n_frames, videos.n_videos, videos.raw, cfg.img_size
    gap = max(nf // rp, 1)

    def gen(generator=None, vids=None, offs=None, scale=None):
        if vids is None:
            vids = torch.randint(0, nv, (bs,), generator=generator)
        if offs is None:
            offs = torch.randint(0, gap, (bs, rp), generator=generator)
        if scale is None:
            scale = 1.2 + 0.3 * torch.rand((bs * rp, 2), generator=generator)
        vids = torch.as_tensor(vids, device=device).long()
        offs = torch.as_tensor(offs, device=device).long()
        scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
        fids = torch.clamp(torch.arange(rp, device=device)[None, :] * gap
                           + offs, max=nf - 1).reshape(-1)
        vids = torch.repeat_interleave(vids, rp)
        theta = (tables["phase"][vids]
                 + 2.0 * math.pi * fids.float() / nf)
        rot = rot_mats(tables["tilt"][vids], theta)
        center, length0 = crop_bbox_analytic(tables, vids, rot,
                                             tables["z0"][vids], raw, n_parts)
        length = torch.clamp((scale * length0.float()).int(), min=1)
        out = render_crop(tables, vids, fids, center, length, s, raw, nf,
                          n_parts)
        out["occ"] = torch.zeros((bs * rp, s, s), device=device)
        return out

    return gen
