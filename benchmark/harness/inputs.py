"""The benchmark's inputs, made on the device from the seed: a frozen copy
of the port's synthetic duo videos (data/synthetic.py SyntheticVideos with
shape 'duo', rendered through each crop's camera as
data/synthetic_device.py renders them) and of the training step's per-step
draws (models/meshnet.py draw_step). The same inputs go to the program and
to the reference.

A video is a ray-traced union of two textured ellipsoids (a big lobe and a
half-size lobe 1.1 radii along +x) turning about y under a fixed tilt, at
4-6 m; frames carry RGB, mask, metric depth in mm and the crop's NDC
intrinsics, at img_size, as the Wild6D reader gives them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RAW = 320          # the raw frame the crop boxes are measured in
N_PARTS = 2


def seed_words(seed: int, *salt: int) -> int:
    """A 63-bit torch seed from the run's seed and a salt: any whole
    number, negative or beyond 64 bits, gives a seed."""
    words = np.random.SeedSequence([seed % (1 << 64), *salt])
    return int(words.generate_state(1, np.uint64)[0] >> np.uint64(1))


def video_tables(n_videos: int, seed: int, device) -> dict:
    """Per-video scene constants, drawn on `device` in one call: part radii
    and centres (2, V, 3), phase, tilt, z0 (V,), the canonical box's centre
    and size (V, 3)."""
    gen = torch.Generator(device=device).manual_seed(seed_words(seed, 1))
    u = torch.rand((n_videos, 6), generator=gen, device=device)
    radii = 0.5 + 0.5 * u[:, :3]
    phase = 2.0 * math.pi * u[:, 3]
    tilt = -0.4 + 0.8 * u[:, 4]
    z0 = 4.0 + 2.0 * u[:, 5]
    zero = torch.zeros_like(radii)
    off = zero.clone()
    off[:, 0] = radii[:, 0] * 1.1
    radii2 = radii * 0.5
    lo = torch.minimum(-radii, off - radii2)
    hi = torch.maximum(radii, off + radii2)
    return dict(radii=torch.stack([radii, radii2]),
                cents=torch.stack([zero, off]), phase=phase, tilt=tilt,
                z0=z0, cb0=(lo + hi) / 2.0, size=hi - lo)


def rot_mats(tilt, theta):
    """R = rot_x(tilt) @ rot_y(theta), (B, 3, 3)."""
    ct, st = torch.cos(tilt), torch.sin(tilt)
    cy, sy = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(ct), torch.ones_like(ct)
    rx = torch.stack([o, z, z, z, ct, -st, z, st, ct], -1).reshape(-1, 3, 3)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(-1, 3, 3)
    return rx @ ry


def part_geometry(radii, cent, rot, z0):
    """M = diag(1/r) R^T, the part's centre cw = R cent + (0, 0, z0), and
    om = -M cw."""
    m = rot.transpose(1, 2) / radii[:, :, None]
    zero = torch.zeros_like(z0)
    cw = torch.einsum("bij,bj->bi", rot, cent) + torch.stack(
        [zero, zero, z0], -1)
    om = torch.einsum("bi,bji->bj", -cw, m)
    return m, om


def part_bbox_dxdy(m, om):
    """The part's silhouette extent in ray-direction (dx, dy) space."""
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


def crop_box(tables, vids, rot, z0):
    """The union's silhouette box in raw pixels: (centre, half length),
    each (B, 2) int32 in (x, y)."""
    foc, pp = RAW * 1.2, RAW / 2.0
    lo = hi = None
    for i in range(N_PARTS):
        m, om = part_geometry(tables["radii"][i][vids],
                              tables["cents"][i][vids], rot, z0)
        plo, phi = part_bbox_dxdy(m, om)
        lo = plo if lo is None else torch.minimum(lo, plo)
        hi = phi if hi is None else torch.maximum(hi, phi)
    imin = torch.clamp(torch.ceil(lo * foc + pp - 0.5), 0, RAW - 1).int()
    imax = torch.clamp(torch.floor(hi * foc + pp - 0.5), 0, RAW - 1).int()
    return (imax + imin) // 2, (imax - imin) // 2


def render(tables, vids, theta, scale, size: int) -> dict:
    """Frames of videos `vids` at turn angles `theta`, each cropped around
    its silhouette box grown by `scale` (B, 2) and rendered at size x size
    through the crop's camera: img, mask, depth (mm), occ, foc_crop and
    pp_crop in NDC units."""
    rot = rot_mats(tables["tilt"][vids], theta)
    z0 = tables["z0"][vids]
    center, length0 = crop_box(tables, vids, rot, z0)
    length = torch.clamp((scale * length0.float()).int(), min=1)
    foc, pp = RAW * 1.2, RAW / 2.0
    lf = length.float()
    cf = (size / 2.0) / lf
    foc_ndc = foc * cf / (size / 2.0)
    x0 = (center - length).float()
    pp_ndc = (pp - x0) * cf / (size / 2.0) - 1.0
    idx = (torch.arange(size, dtype=torch.float32, device=lf.device)
           + 0.5) * 2.0 / size
    dx = (x0[:, 0:1] + idx[None, :] * lf[:, 0:1] - pp) / foc
    dy = (x0[:, 1:2] + idx[None, :] * lf[:, 1:2] - pp) / foc
    b = dx.shape[0]
    d = torch.stack([dx[:, None, :].expand(b, size, size),
                     dy[:, :, None].expand(b, size, size),
                     torch.ones((b, size, size), device=dx.device)], -1)
    t_best = torch.full(d.shape[:-1], math.inf, device=d.device)
    hit = torch.zeros(d.shape[:-1], dtype=torch.bool, device=d.device)
    for i in range(N_PARTS):
        m, om = part_geometry(tables["radii"][i][vids],
                              tables["cents"][i][vids], rot, z0)
        dm = torch.einsum("bhwi,bji->bhwj", d, m)
        a = (dm * dm).sum(-1)
        bq = 2.0 * torch.einsum("bhwi,bi->bhw", dm, om)
        cc = ((om * om).sum(-1) - 1.0)[:, None, None]
        disc = bq * bq - 4.0 * a * cc
        h = disc > 0
        t = torch.where(h, (-bq - torch.sqrt(torch.clamp(disc, min=0)))
                        / (2.0 * a), math.inf)
        t_best = torch.minimum(t_best, t)
        hit = hit | h
    t = torch.where(hit, t_best, 0.0)
    zero = torch.zeros_like(z0)
    c = torch.stack([zero, zero, z0], -1)
    obj = torch.einsum("bhwi,bij->bhwj", d * t[..., None]
                       - c[:, None, None, :], rot)
    u = (obj - tables["cb0"][vids][:, None, None, :]) \
        / (tables["size"][vids][:, None, None, :] / 2.0)
    tex = torch.stack([0.5 + 0.5 * torch.sin(6 * u[..., 0] + 2 * u[..., 2]),
                       0.5 + 0.5 * torch.sin(5 * u[..., 1] - 3 * u[..., 0]),
                       0.5 + 0.5 * torch.cos(4 * u[..., 2] + u[..., 1])], -1)
    shade = 0.4 + 0.6 * torch.clamp(-u[..., 2], 0.0, 1.0)
    img = torch.where(hit[..., None], tex * shade[..., None], 0.05)
    return dict(img=img, mask=hit.float(),
                depth=torch.where(hit, t * 1000.0, 0.0),
                occ=torch.zeros((b, size, size), device=dx.device),
                foc_crop=foc_ndc, pp_crop=pp_ndc)


def train_pool(n_batches: int, videos: int, frames: int, n_videos: int,
               n_frames: int, size: int, seed: int, device) -> list:
    """`n_batches` distinct training batches on `device`, each `videos`
    videos x `frames` frames (video-major, as the pairing losses read it),
    every row of the pool a different (video, frame, crop): the batches
    take the videos in turn, frames spread over the video with an offset
    drawn per row, and crop scales in [1.2, 1.5)."""
    tables = video_tables(n_videos, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed_words(seed, 2))
    gap = max(n_frames // frames, 1)
    rows = n_batches * videos
    vids = torch.arange(rows, device=device) % n_videos
    offs = (torch.arange(rows, device=device) // n_videos) % gap
    fids = torch.clamp(torch.arange(frames, device=device)[None] * gap
                       + offs[:, None], max=n_frames - 1).reshape(-1)
    vids = torch.repeat_interleave(vids, frames)
    scale = 1.2 + 0.3 * torch.rand((rows * frames, 2), generator=gen,
                                   device=device)
    theta = tables["phase"][vids] + 2.0 * math.pi * fids.float() / n_frames
    per = videos * frames
    pool = []
    for i in range(n_batches):
        sl = slice(i * per, (i + 1) * per)
        pool.append(render(tables, vids[sl], theta[sl], scale[sl], size))
    return pool


def test_pool(n_batches: int, batch: int, n_videos: int, n_frames: int,
              size: int, seed: int, device) -> list:
    """`n_batches` host batches (numpy float32) of `batch` distinct test
    frames, cropped at the evaluation's fixed scale 1.35
    (data/synthetic.py SyntheticTest), frames taken in turn over the
    videos."""
    tables = video_tables(n_videos, seed, device)
    n = n_batches * batch
    k = torch.arange(n, device=device)
    vids = k % n_videos
    fids = (k // n_videos) % n_frames
    theta = tables["phase"][vids] + 2.0 * math.pi * fids.float() / n_frames
    scale = torch.full((n, 2), 1.35, device=device)
    pool = []
    for i in range(n_batches):
        sl = slice(i * batch, (i + 1) * batch)
        frames = render(tables, vids[sl], theta[sl], scale[sl], size)
        pool.append({key: v.cpu().numpy() for key, v in frames.items()})
    return pool


def jitter_factors(gen: torch.Generator) -> torch.Tensor:
    """(4,) brightness, contrast, saturation in [0.8, 1.2), hue in
    [-0.05, 0.05), on the CPU (image_ops.jitter_factors)."""
    u = torch.rand(4, generator=gen, dtype=torch.float32)
    lo = torch.tensor([0.8, 0.8, 0.8, -0.05])
    hi = torch.tensor([1.2, 1.2, 1.2, 0.05])
    return lo + u * (hi - lo)


def step_draws(seed: int, step: int, b: int, symmetry_npts: int,
               chamfer: bool) -> dict:
    """One training forward's draws on the CPU, in the order of the
    port's draw_step: the input's colour jitter, the symmetry loss's
    surface samples, the rotation cycle's angle in degrees, the rotated
    batch's jitter, and with the depth chamfer its surface samples."""
    gen = torch.Generator().manual_seed(seed_words(seed, 3, step))
    out = dict(jitter=jitter_factors(gen),
               sym_u=torch.rand((b, symmetry_npts, 1), generator=gen),
               sym_ub=torch.rand((b, symmetry_npts, 2), generator=gen),
               angle=torch.rand((), generator=gen) * 360.0,
               cycle_jitter=jitter_factors(gen), chamfer_u=None,
               chamfer_ub=None)
    if chamfer:
        out["chamfer_u"] = torch.rand((b, 2000, 1), generator=gen)
        out["chamfer_ub"] = torch.rand((b, 2000, 2), generator=gen)
    return out


def predict_draws(seed: int, call: int) -> tuple:
    """The colour jitter (4,) of predict call `call`, and the seed of the
    generator its RANSAC uniforms come from."""
    gen = torch.Generator().manual_seed(seed_words(seed, 4, call))
    return jitter_factors(gen), seed_words(seed, 5, call)
