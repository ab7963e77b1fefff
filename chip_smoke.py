#!/usr/bin/env python
"""On-card smoke test of the PyTorch/CUDA port (selfcorr_tpu_torch).

  python3 chip_smoke.py        # needs one CUDA GPU; exits non-zero without

Phases, in order; any failure exits non-zero:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile the five kernels from the repo's sources, one nvcc per
              source, all started together: in ops/rasterizer/csrc/ B1
              raster_fwd.cu, B2 raster_bwd.cu, B1' raster_fwd_chunk.cu, B2'
              raster_bwd_chunk.cu; B3 ops/csrc/flash_attn.cu; print each
              kernel's registers and spills (nvcc --resource-usage) and the
              forwards' shared-memory loads (LDS, LDS.128) in their SASS
  3. B1       hold the rasterizer forward against its plain PyTorch version
              on the card, all 13 planes, at (a) the panel shape B=1 S=320
              (laptop prior), (b) the training-render shape B=8 S=256 (laptop
              prior under 8 poses; icosphere(3) scattered scene), (c) edge
              cases; wherever B1 or B1' is timed, the (face, pixel) pairs it
              shades (the CPU mirror of its culls, kernel.visited_pairs)
              beside the covered pairs, the faces its warps walk (mean and
              longest), and B1's launch and block cull timed alone
  4. B2       the rasterizer backward against its plain version at the same
              scenes, with seeded random cotangents on the 6 differentiable
              planes: every slot, and a second launch bit-identical; the
              pixels its face boxes visit and the pairs they cover
  5. B1', B2' the dense-chunk forward and backward against their plain
              versions at the same scenes (a)-(c), B1' against B1 on the
              same constants (whether the two are bit-identical is
              recorded), a second B2' launch bit-identical; B1 / B1' and
              B2 / B2' times side by side
  6. texels   B1, B2, B1', B2' with surface texels at R = 6 (K = 192)
              against their plain versions, second backward launches
              bit-identical
  7. B3       the DINO attention against its plain version at the trunk's
              shape (32, 6, 1025, 64) on its strided views and on contiguous
              tensors, and at ragged T on both sides of the kernel's 192-row
              query tiles, 128-key tiles and 16-key short last tile; its
              time over scaled_dot_product_attention's
  8. predict  the predict path (selfcorr_tpu_torch.predict.main) on cuda at
              Wild6D-laptop width on the synthetic eval set with the render
              panels; launch counts are zeroed just before and read just
              after; then warm predict_batch FPS at batch 16 and forward_test
              on the card vs on the CPU
  9. train    the training path (selfcorr_tpu_torch.train.loop.main) on cuda
              at Wild6D-laptop width, batch 8 x 4 = 32, three times, each
              with the launch counts zeroed just before and read just after:
              "train", the compact schedule, 6 steps (B1 = B2 = 6, B3 = 54);
              "train_chunk", the dense-chunk schedule (api.COMPACT = False),
              3 steps (B1' = B2' = 3, B1 = B2 = 0, B3 = 27);
              "train_surface", --surface_texture --n_tex_sample 6, 3 steps
              (B1 = B2 = 3, B3 = 27). Each: every logged loss finite; 5
              timed warm steps and a profile of one; one step
              with the kernels and one with the plain versions patched in
              here, from one state, batch and set of draws, the DINO features
              computed once for both
 10. report   every kernel held against its plain version at each training
              path's inputs (B1' and B2' also at the surface path's, texels
              and all); one JSON line per the kernel table, then the result
              line

Tolerances, B1 (kernel vs plain): alpha 2e-3, depth 1.4e-2 absolute; tex /
match 3.8e-3 relative to max(1, |plain|), which is absolute for colours in
[0, 1] and relative for the depth panel's render, whose "texture" is posed
vertex coordinates (the on-chip gate's bounds of the JAX package; the
sigma=1e-4 sigmoid amplifies rounding ~1e4x at edges); the softmax max planes
m_d / m_t 1e-4 absolute; the softmax sum planes s_d / s_t 1e-3 relative to
max(1, |s|) (with gamma = 1e-4 one ulp of depth moves a softmax weight by
~1e-3).

B1' takes B1's tolerances against its own plain version, with and without
texels.
B2 and B2' (kernel vs plain): every slot within 1e-4 of that slot's largest
plain value (the kernel repeats the plain version's per-pair arithmetic at
-fmad=false; only the order of the per-face sums differs), and finite.
B3 (kernel vs plain): |kernel - plain| <= 2^-7 |plain| + 2^-12 max|v|
elementwise. The two take their f32 sums and exponentials in another order,
so the output may round one bf16 ulp (<= 2^-7 of its value) apart; the floor
is for a p that straddles a bf16 rounding boundary, which moves the output
by one ulp of p times |v| / l, far below 2^-12 max|v| unless p / l is large.
Held at the trunk's shape on random inputs and on "tail" inputs whose real
scores are all far below zero, where the padding keys of the last tile would
take most of the softmax if they were not masked, and at ragged T.
One train step, kernels vs plain versions (from one state with its update
count set to 0, one batch, one set of draws): aux losses 1e-3 relative,
group norms 1e-3 relative, every parameter's gradient before clipping
within 1e-3 of the largest plain gradient of its layer (weight and bias of
one module), and every updated parameter within 1e-1 of its group's
learning rate of the plain update. One AdamW step moves an element by about
its learning rate whatever the gradient, so the update check catches only
gross errors; the gradients are what a wrong slot would move. A parameter
whose plain gradient is below 1e-4 of its layer's is rounding noise (the
deformation head's fc_rgb.bias: the vertex offsets are mean-centred) and
its update is not compared.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 on the tensor cores, HBM3 bandwidth
FP32_PEAK = 67e12
BF16_PEAK = 989e12
HBM_BW = 3.35e12

# fp32 operations per (face, pixel) pair that does each part of the work,
# counted from raster_fwd.cu `shade` (add, multiply, min / max, compare,
# divide and exp count one each); the keys are the plain version's
# pair_counts. "cover": barycentric planes 12, inside test 6, three edge
# distances 54, cutoff tests 2, sign 1, clipped renormalized barycentrics and
# z 22. "cover1" / "cover2": sigmoid and coverage product at one sigma.
# "tex": interpolated texture 15 and streaming-softmax update 19. "depth":
# interpolated camera z 8, softmax update 13, hard test 7. A pair that does
# all of it costs 171. The per-pixel epilogue and the winner's texture (~21
# operations per pixel) are left out.
OPS_PER_PAIR = {"cover": 97, "cover1": 6, "cover2": 6, "tex": 34, "depth": 28}

# fp32 operations per (face, pixel) pair that the gradient needs, by the same
# pair classes: "cover": the geometry of B1 (97), the coverage cotangent (6),
# the dis2 chain (9), the first-edge pick (2), the accumulations of the first
# minimizing edge, the only edge dis2 passes its gradient to (19: ds_raw 3,
# its three SEG slots 5, its E2 slot 6, its three PC slots 5), and those of
# the 1/z, z and texture slots (39); "cover1": the sigma1 sigmoid (6) and
# the depth-softmax chain (31); "cover2": the sigma2 sigmoid (6) and the
# texture-softmax chain (37). A pair covered at both sigmas costs 252.
# (raster_bwd.cu also runs the other two edges' accumulations, which add
# zero; they are the kernel's cost, not the function's, and are not
# charged.)
OPS_PER_PAIR_BWD = {"cover": 172, "cover1": 37, "cover2": 43}

# With surface texels (tex_res = R > 0) the texture comes from one texel
# instead of the interpolated corner colours: the texel pick (cell 8, fold
# test 5, index 3, conversion and clamps 3: 19) replaces the interpolation
# (15) in "tex" of the forward and in "cover2" of the backward, and the
# backward's texture slots take one add per channel (3) instead of the 9
# weighted accumulations (18) in "cover".
OPS_PER_PAIR_TEX = dict(OPS_PER_PAIR, tex=38)
OPS_PER_PAIR_BWD_TEX = {"cover": 157, "cover1": 37, "cover2": 47}
B2_REL_TOL = 1e-4

# the rasterizer kernels by schedule; each `name` has the wrapper
# kernel.<name>_cuda and the plain version reference.<name>_plain
FWD_KERNELS = ("raster_fused_fwd", "raster_fused_fwd_chunk")
BWD_KERNELS = ("raster_fused_bwd", "raster_fused_bwd_chunk")
SIGMAS = (1e-4, 1e-3, 1e-4, 1e-2)    # sigma1, sigma2, gamma_d, gamma_t

TOL = {"alpha1": 2e-3, "alpha2": 2e-3, "depth": 1.4e-2,
       "m_d": 1e-4, "m_t": 1e-4}
REL_TOL = {"texr": 3.8e-3, "texg": 3.8e-3, "texb": 3.8e-3,
           "matr": 3.8e-3, "matg": 3.8e-3, "matb": 3.8e-3,
           "s_d": 1e-3, "s_t": 1e-3}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str):
    print(f"\n=== {name} ===", flush=True)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def rot(ax, ay, az):
    cx, sx = math.cos(ax), math.sin(ax)
    cy, sy = math.cos(ay), math.sin(ay)
    cz, sz = math.cos(az), math.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rx @ ry @ rz).astype(np.float32)


def laptop_scene(rng, b):
    """The laptop prior posed in front of the camera (synthetic-set
    intrinsics: focal 1.2 * raw px, principal point at the centre)."""
    from selfcorr_tpu_torch.ops import mesh_ops as M
    from selfcorr_tpu_torch.ops.rasterizer.common import EYE_OFFSET
    verts, faces = M.load_obj(os.path.join(
        ROOT, "config/wild6d/priors/laptop.obj"))
    verts = M.normalize_prior(verts).astype(np.float32)
    fvs = []
    for _ in range(b):
        R = rot(*rng.uniform(-math.pi, math.pi, 3))
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                      rng.uniform(4.0, 6.0)], np.float32)
        cam = verts @ R + t
        x = cam[:, 0] * 2.4 / cam[:, 2]
        y = -(cam[:, 1] * 2.4 / cam[:, 2])
        fvs.append(np.stack([x, y, cam[:, 2] + EYE_OFFSET], -1)[faces])
    fv = np.stack(fvs).astype(np.float32)
    tex = rng.rand(b, faces.shape[0], 3, 3).astype(np.float32)
    return fv, tex, tex.copy()


def ico_scene(rng, b):
    """icosphere(3) scattered scene of bench.py:280-290."""
    from selfcorr_tpu_torch.ops.mesh_ops import icosphere
    verts, faces = icosphere(3)
    scenes = []
    for _ in range(b):
        s = rng.uniform(0.3, 0.6)
        off = rng.uniform(-0.4, 0.4, (1, 2))
        scenes.append(np.concatenate([verts[:, :2] * s + off,
                                      verts[:, 2:] * s + 5.0], -1))
    fv = np.stack(scenes)[:, faces].astype(np.float32)
    tex = rng.rand(b, faces.shape[0], 3, 3).astype(np.float32)
    return fv, tex, tex.copy()


def random_scene(rng, b, nf, size=0.7, z0=5.0):
    centers = rng.uniform(-0.5, 0.5, (b, nf, 1, 2))
    tri = rng.uniform(-size / 2, size / 2, (b, nf, 3, 2))
    xy = np.clip(centers + tri, -0.95, 0.95)
    z = z0 + rng.uniform(-1.0, 1.0, (b, nf, 3, 1))
    fv = np.concatenate([xy, z], -1).astype(np.float32)
    return (fv, rng.rand(b, nf, 3, 3).astype(np.float32),
            rng.rand(b, nf, 3, 3).astype(np.float32))


def edge_scenes(rng):
    out = {}
    z = np.zeros((2, 0, 3, 3), np.float32)
    out["empty F=0"] = (z, z, z)
    fv, st, ht = random_scene(rng, 2, 8)
    fv[..., :2] += 5.0                      # every face off screen
    out["off-screen"] = (fv, st, ht)
    fv, st, ht = random_scene(rng, 2, 12)
    # rasterizer-space z below NEAR (1.0) on some corners, negative on some
    fv[:, :6, 0, 2] = 0.5
    fv[:, 6:, 1, 2] = rng.uniform(-1.5, 0.9, (2, 6)).astype(np.float32)
    fv[..., 2] = np.where(np.abs(fv[..., 2]) < 0.05, 0.3, fv[..., 2])
    out["behind NEAR"] = (fv, st, ht)
    out["F=21"] = random_scene(rng, 1, 21)
    return out


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

def fwd_compare(ko, po):
    """B1: max |kernel - plain| per plane, and whether every plane is
    within its tolerance (and finite)."""
    errs, ok = {}, True
    for n, ref in po.items():
        d = (ko[n] - ref).abs()
        if n in REL_TOL:
            lim = REL_TOL[n] * torch.clamp(ref.abs(), min=1.0)
        else:
            lim = TOL[n]
        errs[n] = float(d.max()) if d.numel() else 0.0
        ok &= bool((d <= lim).all()) and bool(torch.isfinite(ko[n]).all())
    return errs, ok


def routes(name):
    """The kernel wrapper and the plain version of kernel `name`."""
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.ops.rasterizer import reference as R
    if name == "dino_flash_attn":
        return A.flash_attention_cuda, A.flash_attention_plain
    return getattr(KR, f"{name}_cuda"), getattr(R, f"{name}_plain")


def hold(name, *args):
    """Kernel `name` and its plain version on the same inputs: (the
    kernel's output, its max |kernel - plain| (per plane for a forward),
    whether it is within the tolerance)."""
    kernel, plain = routes(name)
    if name in FWD_KERNELS:
        check = fwd_compare
    elif name in BWD_KERNELS:
        check = bwd_compare
    else:
        def check(ko, po):
            return attn_compare(ko, po, args[2])
    ko, po = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    return (ko, *check(ko, po))


class Capture:
    """Wraps a kernel wrapper of a module while the main path runs, keeping
    the inputs (cloned) of its first call, or of every call with keep_all;
    the count stays the wrapper's."""

    def __init__(self, module, name, keep_all=False):
        self.module, self.name, self.keep_all = module, name, keep_all
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def spy(*args):
            if self.keep_all or not self.calls:
                self.calls.append(tuple(clone(a) for a in args))
            return self.fn(*args)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, dict):
        return {k: clone(v) for k, v in a.items()}
    return a


def time_ms(fn, reps=20, warmup=3, trials=3):
    """ms per call of fn: CUDA events around `reps` calls run back to back
    (so the card never waits on the host between them), the median over
    `trials` such runs; one call, timed alone, for reps=1."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials if reps > 1 else 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def raster_args(name, args):
    """The parts of rasterizer kernel `name`'s arguments: consts, the chunk
    cull (spans, masks; () in the compact schedule), the planes and
    cotangents (a backward's; else ()), the image size, the four sigmas /
    gammas and tex_res."""
    consts, *rest = args
    chunks = pg = ()
    if name.endswith("_chunk"):
        chunks, rest = tuple(rest[:2]), rest[2:]
    if name in BWD_KERNELS:
        pg, rest = tuple(rest[:2]), rest[2:]
    s, *sg = rest[:5]
    return consts, chunks, pg, s, tuple(sg), (rest[5] if len(rest) > 5
                                              else 0)


def visited_pixels(consts, s, sigma1, sigma2):
    """The pixels of the faces' padded boxes (raster_common.cuh face_box,
    in float32 as the kernel computes them), which B2 visits, and the lanes
    that visit them in B2's 8 x 4 sub-tiles."""
    from selfcorr_tpu_torch.ops.rasterizer import common as C
    from selfcorr_tpu_torch.ops.rasterizer.kernel import cull_pad
    bb = consts[..., C.S_BBOX:C.S_BBOX + 4].float()
    pad = torch.tensor(cull_pad(sigma1, sigma2), dtype=torch.float32)
    fs = torch.tensor(float(s))
    xlo, xhi = bb[..., 0] - pad, bb[..., 1] + pad
    ylo, yhi = bb[..., 2] - pad, bb[..., 3] + pad
    ok = (xlo <= 2.0) & (xhi >= -2.0) & (ylo <= 2.0) & (yhi >= -2.0)
    half = torch.tensor(0.5)
    cl = torch.clamp((xlo * fs + fs - 1.0) * half, min=0.0)
    ch = torch.clamp((xhi * fs + fs - 1.0) * half, max=float(s - 1))
    rl = torch.clamp((fs - 1.0 - yhi * fs) * half, min=0.0)
    rh = torch.clamp((fs - 1.0 - ylo * fs) * half, max=float(s - 1))
    c_lo = torch.clamp(torch.floor(cl) - 1, min=0)
    c_hi = torch.clamp(torch.ceil(ch) + 1, max=s - 1)
    r_lo = torch.clamp(torch.floor(rl) - 1, min=0)
    r_hi = torch.clamp(torch.ceil(rh) + 1, max=s - 1)
    ncol = torch.where(ok, c_hi - c_lo + 1, 0).clamp(min=0)
    nrow = torch.where(ok, r_hi - r_lo + 1, 0).clamp(min=0)
    lanes = torch.ceil(ncol / 8) * 8 * torch.ceil(nrow / 4) * 4
    return int((ncol * nrow).sum()), int(lanes.sum())


def raster_costs(name, *args):
    """Kernel and plain times of rasterizer kernel `name` on args (the
    plain version once, after hold has run it on the same inputs), and the
    bound of the function, the same for both schedules: the larger of the
    operations of the (face, pixel) pairs that do work (counted by the
    compact plain forward's own masks, times OPS_PER_PAIR[_BWD][_TEX]) over
    the fp32 peak, and the bytes read once and written once (the constants,
    the chunk cull, 13 output planes for a forward; the constants, the cull,
    16 planes and the gradient for a backward) over HBM bandwidth."""
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_plain
    kernel, plain = routes(name)
    consts, chunks, _, s, sg, tex_res = raster_args(name, args)
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args), reps=1, warmup=0)
    pairs = {}
    raster_fused_fwd_plain(consts, s, *sg, tex_res, pair_counts=pairs)
    bwd = name in BWD_KERNELS
    per_pair = ((OPS_PER_PAIR_BWD_TEX if tex_res else OPS_PER_PAIR_BWD)
                if bwd else (OPS_PER_PAIR_TEX if tex_res else OPS_PER_PAIR))
    ops = sum(n * pairs[k] for k, n in per_pair.items())
    b, f, k = consts.shape
    nbytes = (b * f * k * 4 * (2 if bwd else 1)
              + sum(t.numel() * 4 for t in chunks)
              + (16 if bwd else 13) * b * s * s * 4)
    t_ops = ops / FP32_PEAK * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    out = dict(ms=ms, plain_ms=plain_ms, pairs=pairs, ops=ops, bytes=nbytes,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    if bwd:
        out["visited_pixels"], out["visited_lanes"] = visited_pixels(
            consts.cpu(), s, *sg[:2])
    else:
        out.update(fwd_cull(name, consts, chunks, s, sg[:2]))
    if name == "raster_fused_fwd":
        # B1's launch and block cull alone, timed without host gaps: what a
        # cheaper block cull could save at most
        moved = off_screen(consts)
        out["cull_only_ms"] = graph_ms(lambda: kernel(moved, *args[1:]))
    return out


def off_screen(consts):
    """consts with every face's bbox moved off screen: B1 on them runs its
    launch and its block cull of every face, and shades nothing."""
    from selfcorr_tpu_torch.ops.rasterizer import common as C
    moved = consts.clone()
    moved[..., C.S_BBOX:C.S_BBOX + 2] += 10.0
    return moved


def graph_ms(fn, reps=20):
    """ms per call of fn: `reps` calls captured in one CUDA graph, its
    replay timed by CUDA events, the median of 3 replays; the card runs
    the kernels with no host work between them, however short they are."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def fwd_cull(name, consts, chunks, s, sigmas):
    """The (face, pixel) pairs on which forward `name` runs shade, from the
    CPU mirror of its culls (kernel.visited_pairs), and the pairs the earlier
    16 x 16 block cull of B1 shaded at the same inputs."""
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    consts = consts.cpu()
    chunks = tuple(t.cpu() for t in chunks) or None
    # faces each warp shades: a warp walks them one after another, so the
    # longest walk is the kernel's critical path when few warps are busy
    faces = KR.fwd_visits(consts, s, *sigmas, chunks).sum(-1).flatten()
    busy = faces[faces > 0].float()
    return {"visited_pairs": KR.visited_pairs(consts, s, *sigmas, chunks),
            "block16_cull_pairs": KR.block_cull_pairs(consts, s, *sigmas),
            "warp_faces_max": int(faces.max()),
            "warp_faces_mean": float(busy.mean()) if busy.numel() else 0.0,
            "busy_warps": int(busy.numel())}


def print_fwd(tag, where, c):
    """A forward's time beside its bound, and the pairs it shaded beside
    the covered ones."""
    print(f"[{tag}] {where}: kernel {c['ms']} ms, plain {c['plain_ms']} ms, "
          f"bound {c['bound_ms']} ms ({c['bound_by']}; "
          f"{100 * c['bound_ms'] / c['ms']:.1f}% of the bound); pairs "
          f"shaded {c['visited_pairs']} = "
          f"{c['visited_pairs'] / max(c['pairs']['cover'], 1):.3f}x the "
          f"{c['pairs']['cover']} covered (a 16 x 16 block cull: "
          f"{c['block16_cull_pairs']}); faces a busy warp shades: mean "
          f"{c['warp_faces_mean']:.1f}, longest {c['warp_faces_max']} "
          f"({c['busy_warps']} busy warps)"
          + (f"; launch and block cull alone (every bbox off screen, "
             f"CUDA-graph replay): {c['cull_only_ms']} ms"
             if "cull_only_ms" in c else ""), flush=True)


def pack(dev, s, fv, st, ht, surf=None):
    """The sorted, padded constants of a scene for image size s, packed as
    render_fused packs them, on the card."""
    from selfcorr_tpu_torch.ops.rasterizer import common as C
    return C.pack_constants(
        *(torch.tensor(a, device=dev) for a in (fv, st, ht)),
        surf_tex=None if surf is None else torch.tensor(surf, device=dev),
        n_bands=C.bands_for(s))


def kernel_phase(rng, dev):
    from selfcorr_tpu_torch.ops.rasterizer import common as C
    cases = []
    fv, st, ht = laptop_scene(rng, 1)
    cases.append(("(a) panel laptop B=1 S=320", fv, st, ht, 320,
                  [(1e-4, 1e-3, 1e-4, 1e-4)], True))
    fv, st, ht = laptop_scene(rng, 8)
    cases.append(("(b) laptop 8 poses B=8 S=256", fv, st, ht, 256,
                  [(1e-4, 1e-3, 1e-4, 1e-2)], True))
    fv, st, ht = ico_scene(rng, 8)
    cases.append(("(b) ico(3) scattered B=8 S=256", fv, st, ht, 256,
                  [(1e-4, 1e-3, 1e-4, 1e-2)], True))
    for name, (fv, st, ht) in edge_scenes(rng).items():
        cases.append((f"(c) {name}", fv, st, ht, 64,
                      [(1e-4, 1e-3, 1e-4, 1e-2), (1e-4, 1e-3, 1e-4, 1e-4)],
                      False))
    timings = {}
    failures = []
    for name, fv, st, ht, s, sigmas, timed in cases:
        consts = C.pack_constants(torch.tensor(fv, device=dev),
                                  torch.tensor(st, device=dev),
                                  torch.tensor(ht, device=dev))
        for sg in sigmas:
            _, errs, ok = hold("raster_fused_fwd", consts, s, *sg)
            tag = f"{name} gamma_t={sg[3]:g}"
            print(f"[kernel] {tag}: F={consts.shape[1]} max|err| "
                  + " ".join(f"{n}={e:.3g}" for n, e in errs.items()),
                  flush=True)
            if not ok:
                failures.append(tag)
            if timed:
                c = raster_costs("raster_fused_fwd", consts, s, *sg)
                timings[name] = c
                print(f"[kernel] {tag}: {c['ops']} operations over pairs "
                      f"{c['pairs']}; {c['bytes']} bytes", flush=True)
                print_fwd("kernel", tag, c)
    if failures:
        fail("kernel disagrees with its plain version: "
             + "; ".join(failures))
    return timings


def bwd_compare(kg, pg):
    """Largest |kernel - plain| of the backward, and whether every slot is
    within B2_REL_TOL of that slot's largest plain value (and finite)."""
    if pg.numel() == 0:
        return 0.0, kg.shape == pg.shape
    err = (kg - pg).abs()
    lim = B2_REL_TOL * pg.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    ok = bool((err <= lim).all()) and bool(torch.isfinite(kg).all())
    return float(err.max()), ok


def random_grads(rng, b, s, dev):
    from selfcorr_tpu_torch.ops.rasterizer.reference import BWD_GRADS
    return {n: torch.tensor(rng.randn(b, s, s).astype(np.float32),
                            device=dev) for n in BWD_GRADS}


def scene_cases(rng):
    """The scenes (a)-(c) as (name, fv, st, ht, S, timed)."""
    cases = [("(a) panel laptop B=1 S=320", *laptop_scene(rng, 1), 320, True),
             ("(b) laptop 8 poses B=8 S=256", *laptop_scene(rng, 8), 256,
              True),
             ("(b) ico(3) scattered B=8 S=256", *ico_scene(rng, 8), 256,
              True)]
    cases += [(f"(c) {n}", *sc, 64, False)
              for n, sc in edge_scenes(rng).items()]
    return cases


def print_b2(where, c):
    print(f"[B2] {where}: kernel {c['ms']} ms, plain {c['plain_ms']} ms, "
          f"bound {c['bound_ms']} ms ({c['bound_by']}; {c['ops']} operations "
          f"over pairs {c['pairs']}; {c['bytes']} bytes); pixels visited "
          f"{c['visited_pixels']} (lanes {c['visited_lanes']}), covered "
          f"pairs {c['pairs']['cover']}", flush=True)


def b2_phase(rng, dev):
    from selfcorr_tpu_torch.ops.rasterizer import common as C
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_plain
    sg = SIGMAS
    timings, failures = {}, []
    for name, fv, st, ht, s, timed in scene_cases(rng):
        consts = C.pack_constants(*(torch.tensor(a, device=dev)
                                    for a in (fv, st, ht)))
        planes = raster_fused_fwd_plain(consts, s, *sg)
        grads = random_grads(rng, consts.shape[0], s, dev)
        kg, err, ok = hold("raster_fused_bwd", consts, planes, grads, s, *sg)
        same = torch.equal(kg, KR.raster_fused_bwd_cuda(consts, planes, grads,
                                                        s, *sg))
        print(f"[B2] {name}: F={consts.shape[1]} max|err| {err:.3g} (slot "
              f"scale up to {float(kg.abs().max()) if kg.numel() else 0:.3g})"
              f"; repeat bit-identical: {same}", flush=True)
        if not ok:
            failures.append(f"{name}: disagrees with the plain version")
        if not same:
            failures.append(f"{name}: a second launch differs")
        if timed:
            c = raster_costs("raster_fused_bwd", consts, planes, grads, s,
                             *sg)
            timings[name] = c
            print_b2(name, c)
    if failures:
        fail("B2: " + "; ".join(failures))
    return timings


def chunk_phase(rng, dev):
    """B1' and B2' against their plain versions at the scenes (a)-(c); B1'
    against B1 on the same sorted constants (bit-identical or not,
    recorded); a second B2' launch bit-identical; at the timed scenes the
    kernel times of both schedules side by side."""
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.ops.rasterizer.api import chunk_info
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_chunk_plain
    sg = SIGMAS
    out, failures = {}, []
    for name, fv, st, ht, s, timed in scene_cases(rng):
        consts = pack(dev, s, fv, st, ht)
        cull = chunk_info(consts, s, *sg[:2])
        ko, errs, ok = hold("raster_fused_fwd_chunk", consts, *cull, s, *sg)
        b1 = KR.raster_fused_fwd_cuda(consts, s, *sg)
        same_b1 = all(torch.equal(ko[n], b1[n]) for n in ko)
        planes = raster_fused_fwd_chunk_plain(consts, *cull, s, *sg)
        grads = random_grads(rng, consts.shape[0], s, dev)
        bargs = (consts, *cull, planes, grads, s, *sg)
        kg, err, ok_b = hold("raster_fused_bwd_chunk", *bargs)
        again = torch.equal(kg, KR.raster_fused_bwd_chunk_cuda(*bargs))
        rec = {"fwd_max_abs_err": errs, "bwd_max_abs_err": err,
               "b1_bit_identical": same_b1, "bwd_repeat_bit_identical": again,
               "chunks_visited": int(torch.stack(
                   [(cull[1] >> i) & 1 for i in range(32)]).sum())}
        print(f"[B1'/B2'] {name}: F={consts.shape[1]} B1' max|err| "
              + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
              + f"; B1' == B1 bit for bit: {same_b1}; B2' max|err| "
              f"{err:.3g}; B2' repeat bit-identical: {again}; "
              f"(tile, chunk) pairs visited {rec['chunks_visited']}",
              flush=True)
        failures += ([] if ok else [f"{name}: B1' disagrees"]) \
            + ([] if ok_b else [f"{name}: B2' disagrees"]) \
            + ([] if again else [f"{name}: a second B2' launch differs"])
        if timed:
            rec.update(
                b1_chunk_ms=time_ms(lambda: KR.raster_fused_fwd_chunk_cuda(
                    consts, *cull, s, *sg)),
                b1_ms=time_ms(lambda: KR.raster_fused_fwd_cuda(consts, s,
                                                               *sg)),
                b2_chunk_ms=time_ms(lambda: KR.raster_fused_bwd_chunk_cuda(
                    *bargs)),
                b2_ms=time_ms(lambda: KR.raster_fused_bwd_cuda(
                    consts, planes, grads, s, *sg)))
            print(f"[B1'/B2'] {name}: B1' {rec['b1_chunk_ms']} ms vs B1 "
                  f"{rec['b1_ms']} ms; B2' {rec['b2_chunk_ms']} ms vs B2 "
                  f"{rec['b2_ms']} ms", flush=True)
        out[name] = rec
    if failures:
        fail("B1'/B2': " + "; ".join(failures))
    return out


TEX_RES = 6     # the JAX default n_tex_sample: K = 192


def texel_phase(rng, dev):
    """B1, B2, B1', B2' with random surface texels at R = TEX_RES against
    their plain versions: the laptop prior under 8 poses at S=256 and F=21
    at S=64; second backward launches bit-identical."""
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.ops.rasterizer.api import chunk_info
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_plain
    sg, r = SIGMAS, TEX_RES
    cases = [("(b) laptop 8 poses B=8 S=256", *laptop_scene(rng, 8), 256),
             ("(c) F=21 S=64", *random_scene(rng, 1, 21), 64)]
    out, failures = {}, []
    for name, fv, st, ht, s in cases:
        surf = rng.rand(*fv.shape[:2], r * r, 3).astype(np.float32)
        consts = pack(dev, s, fv, st, ht, surf)
        cull = chunk_info(consts, s, *sg[:2])
        planes = raster_fused_fwd_plain(consts, s, *sg, r)
        grads = random_grads(rng, consts.shape[0], s, dev)
        rec = {}
        for kname, args in (
                ("raster_fused_fwd", (consts, s, *sg, r)),
                ("raster_fused_fwd_chunk", (consts, *cull, s, *sg, r)),
                ("raster_fused_bwd", (consts, planes, grads, s, *sg, r)),
                ("raster_fused_bwd_chunk", (consts, *cull, planes, grads, s,
                                            *sg, r))):
            ko, err, ok = hold(kname, *args)
            rec[kname] = {"max_abs_err": err}
            if kname in BWD_KERNELS:
                again = torch.equal(ko, routes(kname)[0](*args))
                rec[kname]["repeat_bit_identical"] = again
                failures += [] if again else [f"{name}: {kname} repeat"]
            else:
                rec[kname]["out"] = ko
            failures += [] if ok else [f"{name}: {kname} disagrees"]
        fwd, fwd_c = (rec[n].pop("out") for n in FWD_KERNELS)
        rec["b1_chunk_b1_bit_identical"] = all(
            torch.equal(fwd[n], fwd_c[n]) for n in fwd)
        print(f"[texels] {name} R={r} K={consts.shape[2]}: " + "; ".join(
            f"{n} {v}" for n, v in rec.items()), flush=True)
        out[name] = rec
    if failures:
        fail("texels: " + "; ".join(failures))
    return out


def attn_compare(ko, po, v):
    """Largest |kernel - plain|, and whether every element is within
    2^-7 |plain| + 2^-12 max|v| (see the module docstring)."""
    k, p = ko.float(), po.float()
    err = (k - p).abs()
    lim = 2.0 ** -7 * p.abs() + 2.0 ** -12 * float(v.float().abs().max())
    ok = bool((err <= lim).all()) and bool(torch.isfinite(k).all())
    return (float(err.max()) if err.numel() else 0.0), ok


def attn_costs(q, k, v):
    """B3, plain and scaled_dot_product_attention times on the same bf16
    inputs, and the bound: the larger of 4 B H T^2 d operations over the
    dense bf16 peak and q, k, v read once plus o written once over HBM
    bandwidth."""
    from selfcorr_tpu_torch.ops import attention as A
    b, h, t, d = q.shape
    ms = time_ms(lambda: A.flash_attention_cuda(q, k, v))
    plain_ms = time_ms(lambda: A.flash_attention_plain(q, k, v), reps=5,
                       warmup=1)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v))
    ops = 4 * b * h * t * t * d
    nbytes = 4 * b * h * t * d * 2
    t_ops = ops / BF16_PEAK * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops=ops,
                bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def qkv_views(b, h, t, dev, gen, tail=False, contiguous=False):
    """q, k, v (B, H, T, 64) bf16 views of one (B, T, 3, H, 64) tensor, the
    trunk's layout, or with `contiguous` three contiguous tensors. With
    `tail`, q >= 0 and k <= 0, so every real score is far below the 0 that
    an unmasked zero padding key would score."""
    qkv = torch.randn((b, t, 3, h, 64), generator=gen, device=dev)
    if tail:
        qkv[:, :, 0] = qkv[:, :, 0].abs()
        qkv[:, :, 1] = -qkv[:, :, 1].abs()
    qkv = qkv.bfloat16()
    views = tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
    return tuple(x.contiguous() for x in views) if contiguous else views


# B3's tiles (ops/csrc/flash_attn.cu): 192 query rows per block in three
# consumers of 64, 128 keys per tile, and a last key tile of at most 16
# keys run short. (name, (B, H, T), tail, contiguous)
B3_QTILE, B3_KTILE = 192, 128
B3_CASES = (("trunk", (32, 6, 1025), False, False),
            ("trunk tail", (32, 6, 1025), True, False),
            ("trunk contiguous", (32, 6, 1025), False, True),
            ("T=1", (2, 6, 1), False, False),
            ("T=64", (2, 6, 64), False, False),
            ("T=65", (2, 6, 65), False, False),
            ("T=129", (2, 6, 129), False, False)) + tuple(
    (f"T={t}", (2, 6, t), True, False)
    for t in (B3_KTILE - 1, B3_KTILE, B3_KTILE + 1, B3_KTILE + 16,
              B3_KTILE + 17, 2 * B3_KTILE + 1, B3_QTILE - 1, B3_QTILE,
              B3_QTILE + 1, 2 * B3_QTILE + 1)) + (
    (f"T={2 * B3_QTILE + 1} contiguous", (3, 2, 2 * B3_QTILE + 1), False,
     True),)


def print_b3(where, c):
    print(f"[B3] {where}: kernel {c['ms']} ms, plain {c['plain_ms']} ms, "
          f"scaled_dot_product_attention {c['library_ms']} ms (kernel / SDPA "
          f"{c['ms'] / c['library_ms']:.3f}), bound {c['bound_ms']} ms "
          f"({c['bound_by']}; {c['ops']} operations, {c['bytes']} bytes; "
          f"{100 * c['bound_ms'] / c['ms']:.1f}% of the bound)", flush=True)


def b3_phase(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    failures, cost, errs = [], None, {}
    for name, shape, tail, contiguous in B3_CASES:
        q, k, v = qkv_views(*shape, dev, gen, tail, contiguous)
        _, err, ok = hold("dino_flash_attn", q, k, v)
        errs[name] = err
        print(f"[B3] {name} (B, H, T) = {shape}: max|err| {err:.3g}",
              flush=True)
        if not ok:
            failures.append(f"{name}: disagrees with the plain version")
        if name == "trunk":
            cost = attn_costs(q, k, v)
            print_b3(str(shape), cost)
    if failures:
        fail("B3: " + "; ".join(failures))
    return dict(cost, max_abs_err_by_case=errs)


# ---------------------------------------------------------------------------
# the predict slice
# ---------------------------------------------------------------------------

SLICE_ARGS = ["--flagfile", "config/wild6d/laptop.txt",
              "--dataset_name", "synthetic", "--eval", "--eval_nocs",
              "--vis_pred", "--visualize_mask", "--visualize_tex",
              "--visualize_depth", "--batch_size", "16", "--repeat", "1",
              "--dframe_eval", "1"]


def slice_phase():
    from selfcorr_tpu_torch import predict
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR

    run_args = SLICE_ARGS + ["--checkpoint_dir", OUT, "--name", "predict"]
    with Capture(KR, "raster_fused_fwd_cuda", keep_all=True) as cap:
        reset_launches()
        t0 = time.time()
        results = predict.main(["predict"] + run_args)
        torch.cuda.synchronize()
        launches = read_launches()
    wall = time.time() - t0
    print(f"[slice] predict.main wall {wall:.2f} s (cold: data, first "
          f"launches); kernel launches {launches}", flush=True)
    keys = ("iou@25", "iou@50", "5deg2cm", "5deg5cm", "10deg2cm", "10deg5cm")
    for k in keys:
        print(f"[slice] {k}: {results.get(k)}")
    if not all(k in results and math.isfinite(results[k]) for k in keys):
        fail(f"NOCS metrics missing or not finite: {results}")
    if results.get("count") != 12:
        fail(f"expected 12 valid samples, got {results.get('count')}")
    vis = os.path.join(OUT, "predict", "vis")
    pngs = sorted(p for p in os.listdir(vis) if p.endswith(".png"))
    print(f"[slice] {len(pngs)} panels in {vis}")
    if len(pngs) != 36:
        fail(f"expected 36 panels (12 samples x depth/tex/mask), got "
             f"{len(pngs)}")
    if launches["raster_fused_fwd"] == 0:
        fail("the predict path never launched raster_fused_fwd")
    cfg = parse_args(run_args).replace(train=False, device="cuda")
    return cfg, launches, cap.calls


def fps_and_cpu_parity(cfg, card: str):
    from selfcorr_tpu_torch.data.loader import TestLoader
    from selfcorr_tpu_torch.eval.tester import Tester, make_test_dataset
    from selfcorr_tpu_torch.models.meshnet import forward_test

    tester = Tester(cfg.replace(vis_pred=False))
    loader = TestLoader(make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    tester.predict_batch(batch)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.time()
    for _ in range(reps):
        tester.predict_batch(batch)
    torch.cuda.synchronize()
    per_batch = (time.time() - t0) / reps
    fps = cfg.batch_size / per_batch
    print(f"[slice] warm predict_batch (forward_test + fit_poses), batch "
          f"{cfg.batch_size}: {per_batch * 1e3:.2f} ms/batch = {fps:.1f} "
          f"frames/s over {reps} repeats on {card}", flush=True)

    breakdown = profile_calls(lambda: tester.predict_batch(batch), 3,
                              "predict_batch", "predict_profile.txt")

    jitter = torch.tensor([1.1, 0.9, 1.05, 0.02])
    gpu = forward_test(tester.model, tester.to_device(batch),
                       tester.constants, cfg, jitter=jitter)
    cpu_tester = Tester(cfg.replace(vis_pred=False, device="cpu"),
                        model=tester.model.cpu())
    cpu = forward_test(cpu_tester.model, cpu_tester.to_device(batch),
                       cpu_tester.constants, cfg, jitter=jitter)
    worst = {}
    for k in ("pred_v", "tex", "imatch", "match", "match_conf", "rotation",
              "translation", "scale"):
        worst[k] = float((gpu[k].cpu() - cpu[k]).abs().max())
    print("[slice] forward_test cuda vs cpu max|err|: "
          + " ".join(f"{k}={v:.3g}" for k, v in worst.items()), flush=True)
    bad = [k for k, v in worst.items() if not v <= 1e-3]
    if bad:
        fail(f"forward_test on cuda disagrees with the CPU beyond 1e-3: "
             f"{bad}")
    return per_batch, fps, breakdown


def profile_calls(fn, reps: int, label: str, filename: str):
    """Where `reps` warm calls of fn spend their time: device time by kernel
    and by PyTorch op (torch.profiler), and the share of the calls' wall
    time in which the device ran a kernel. The full table goes to
    chiprun_out/chip_smoke/<filename>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / reps
    avg = prof.key_averages()
    with open(os.path.join(OUT, filename), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=60))

    def top(events, n=10):
        ev = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
        return [(e.key[:70], e.self_device_time_total / 1e3 / reps,
                 e.count // reps) for e in ev if e.self_device_time_total > 0]

    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    ops = [e for e in avg if e.device_type == DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    print(f"[profile] {label}: {wall_ms:.2f} ms wall per call, "
          f"device busy {busy_ms:.2f} ms "
          f"({100.0 * busy_ms / wall_ms:.1f}%)", flush=True)
    by_kernel, by_op = top(kernels), top(ops)
    for name, ms, n in by_op:
        print(f"[profile] op {ms:8.3f} ms x{n:<4d} {name}")
    for name, ms, n in by_kernel:
        print(f"[profile] kernel {ms:8.3f} ms x{n:<4d} {name}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "by_op": by_op, "by_kernel": by_kernel}


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--flagfile", "config/wild6d/laptop.txt",
              "--dataset_name", "synthetic", "--batch_log_interval", "1"]
ATTN_PER_STEP = 9   # attention blocks of the DINO trunk that a step runs
# the training paths: steps, extra flags, the rasterizer schedule
# (api.COMPACT) and the rasterizer kernels that each step launches once
TRAIN_PATHS = {
    "train": (6, [], True, ("raster_fused_fwd", "raster_fused_bwd")),
    "train_chunk": (3, [], False, ("raster_fused_fwd_chunk",
                                   "raster_fused_bwd_chunk")),
    "train_surface": (3, ["--surface_texture", "--n_tex_sample",
                          str(TEX_RES)], True,
                      ("raster_fused_fwd", "raster_fused_bwd")),
}


@contextlib.contextmanager
def schedule(compact: bool):
    """The rasterizer schedule render_fused takes while the block runs."""
    from selfcorr_tpu_torch.ops.rasterizer import api
    saved = api.COMPACT
    api.COMPACT = compact
    try:
        yield
    finally:
        api.COMPACT = saved


def reset_launches():
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    KR.reset_launches()
    A.reset_launches()


def read_launches():
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    return {**KR.LAUNCHES, **A.LAUNCHES}


def train_phase(path: str):
    """Training path `path` of TRAIN_PATHS through its entry point, with
    the launch counts of its run and each of its kernels' first inputs
    there."""
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.train import loop
    steps, extra, compact, raster = TRAIN_PATHS[path]
    args = TRAIN_ARGS + ["--total_iters", str(steps), *extra,
                         "--checkpoint_dir", OUT, "--name", path]
    with schedule(compact), contextlib.ExitStack() as stack:
        caps = {n: stack.enter_context(Capture(KR, f"{n}_cuda"))
                for n in raster}
        caps["dino_flash_attn"] = stack.enter_context(
            Capture(A, "flash_attention_cuda"))
        reset_launches()
        t0 = time.time()
        trainer = loop.main(["train"] + args)
        torch.cuda.synchronize()
        launches = read_launches()
    wall = time.time() - t0
    print(f"[{path}] loop.main {steps} steps, wall {wall:.2f} s (cold: "
          f"data, first launches); kernel launches {launches}", flush=True)
    want = {n: steps if n in raster else 0 for n in launches}
    want["dino_flash_attn"] = ATTN_PER_STEP * steps
    if launches != want:
        fail(f"{path}: launches {launches}, expected {want}: one render "
             f"({' forward, '.join(raster)} backward) and {ATTN_PER_STEP} "
             f"attention blocks per step")
    logged = trainer.logged
    bad = [(st, k, v) for st, vals in logged for k, v in vals.items()
           if not math.isfinite(v)]
    if len(logged) != steps or bad:
        fail(f"{path}: logged {len(logged)} of {steps} steps; non-finite "
             f"metrics: {bad}")
    print(f"[{path}] logged total_loss: "
          + " ".join(f"{v['total_loss']:.8f}" for _, v in logged))
    return trainer, launches, {n: c.calls[0] for n, c in caps.items()}


def train_batch(trainer):
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.train.loop import (make_train_dataset,
                                               step_generator)
    from selfcorr_tpu_torch.train.step import compress_batch_host
    from selfcorr_tpu_torch.data.loader import stack_items
    cfg = trainer.cfg
    ds = make_train_dataset(cfg)
    host = stack_items([ds.load_item(*a) for a in ds.sample_plan(0)])
    batch = trainer.upload(compress_batch_host(host))
    draws = draw_step(step_generator(cfg.seed, 100), cfg,
                      batch["img"].shape[0])
    return batch, draws


def train_timing(trainer, card: str, path: str, reps: int = 5):
    """Warm train_step time on one device batch (the loop's data loading
    excluded), with every loss finite, and a profile of one step."""
    from selfcorr_tpu_torch.train.step import train_step
    cfg = trainer.cfg
    batch, draws = train_batch(trainer)
    b = batch["img"].shape[0]
    train_step(trainer.state, batch, draws, cfg)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.time()
        m = train_step(trainer.state, batch, draws, cfg)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        if bad:
            fail(f"{path}: a timed train step gave non-finite {bad}")
    step_ms = statistics.median(times) * 1e3
    print(f"[{path}] warm train_step at batch {b}: median {step_ms:.2f} ms "
          f"over {reps} steps ({', '.join(f'{t * 1e3:.1f}' for t in times)})"
          f" = {b / step_ms * 1e3:.1f} imgs/s on {card}", flush=True)
    prof = profile_calls(lambda: train_step(trainer.state, batch, draws, cfg),
                         1, f"{path} train_step", f"{path}_profile.txt")
    return step_ms, b / step_ms * 1e3, prof


def step_kernels_vs_plain(state, batch, draws, cfg, path="train"):
    """One train step with the kernels and one with the plain versions
    patched in (all four rasterizer wrappers), each from a copy of `state`
    with its update count set to 0 (learning rates 1/25 of the peaks), on
    one batch and set of draws; the DINO features are computed once and fed
    to both (dino_pair_match takes argmaxes). Compares the metrics, every
    parameter's gradient before clipping (taken where train_step hands it to
    clip_and_guard) and the updated parameters."""
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.train import step as ST
    with torch.no_grad():
        feats = state.dino(batch["img"].float() / 255.0)
    lrs = state.optimizer.lrs(0)
    lr_of = {n: lrs[g] for g, ps in state.optimizer.groups.items()
             for n, _ in ps}
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    runs = {}
    for route in ("kernels", "plain"):
        st = copy.deepcopy(state)
        st.step = 0
        st.dino = lambda img: feats
        grads = {}
        guard = ST.clip_and_guard

        def keep_grads(model):
            grads.update({n: p.grad.clone()
                          for n, p in model.named_parameters()})
            return guard(model)

        names = [f"{n}_cuda" for n in FWD_KERNELS + BWD_KERNELS]
        saved = {n: getattr(KR, n) for n in names}
        ST.clip_and_guard = keep_grads
        if route == "plain":
            for n in FWD_KERNELS + BWD_KERNELS:
                setattr(KR, f"{n}_cuda", routes(n)[1])
        try:
            m = ST.train_step(st, batch, draws, cfg)
            torch.cuda.synchronize()
        finally:
            for n, fn in saved.items():
                setattr(KR, n, fn)
            ST.clip_and_guard = guard
        runs[route] = ({k: float(v) for k, v in m.items()}, grads,
                       {n: p.detach() for n, p in
                        st.model.named_parameters()})
    (mk, gk, pk), (mp, gp, pp) = runs["kernels"], runs["plain"]

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    aux = {k: rel(mk[k], mp[k]) for k in mk
           if not k.startswith("grad_") and k != "bad_grad"}
    norms = {k: rel(mk[k], mp[k]) for k in mk if k.startswith("grad_")}
    # each gradient against the largest plain gradient of its layer (the
    # weight and bias of one module): a leaf whose gradient is zero but for
    # rounding (the deformation head's fc_rgb.bias, which the mean-centring
    # of the vertex offsets cancels) has no scale of its own
    scale = {}
    for n, g in gp.items():
        mod = n.rsplit(".", 1)[0]
        scale[mod] = max(scale.get(mod, 0.0), float(g.abs().max()))
    of_layer = {n: max(scale[n.rsplit(".", 1)[0]], 1e-30) for n in gp}
    grad = {n: float((gk[n] - gp[n]).abs().max()) / of_layer[n] for n in gp}
    # each update against its group's learning rate, past the one float32
    # rounding of the new value (2^-23 of it) that either route may take;
    # not for a rounding-noise leaf, whose update is AdamW's answer to noise
    noise = [n for n in lr_of
             if float(gp[n].abs().max()) < 1e-4 * of_layer[n]]
    upd = {n: float(((pk[n] - pp[n]).abs() - 2.0 ** -23 * pp[n].abs())
                    .clamp(min=0).max()) / lr_of[n]
           for n in lr_of if n not in noise}
    for n in pp:
        if n not in lr_of and not torch.equal(pp[n], before[n]):
            fail(f"the frozen parameter {n} moved")
    print(f"[{path}] gradients that are rounding noise (< 1e-4 of their "
          f"layer's largest), updates not compared: {noise}", flush=True)
    worst = {"aux": max(aux, key=aux.get), "norms": max(norms, key=norms.get),
             "grad": max(grad, key=grad.get), "upd": max(upd, key=upd.get)}
    print(f"[{path}] one step at count 0, kernels vs plain: aux losses max "
          f"rel err {aux[worst['aux']]:.3g} ({worst['aux']}); group norms "
          f"max rel err {norms[worst['norms']]:.3g} ({worst['norms']}); "
          f"gradients max err {grad[worst['grad']]:.3g} of the layer's "
          f"largest ({worst['grad']}); updated parameters max err "
          f"{upd[worst['upd']]:.3g} of the group's lr ({worst['upd']})",
          flush=True)
    for name, d in (("gradient", grad), ("update", upd)):
        top = sorted(d, key=d.get, reverse=True)[:5]
        print(f"[{path}]   largest {name} errors: "
              + ", ".join(f"{n} {d[n]:.3g}" for n in top), flush=True)
    bad = ([k for k, e in aux.items() if not e <= 1e-3]
           + [k for k, e in norms.items() if not e <= 1e-3]
           + [f"grad {n}" for n, e in grad.items() if not e <= 1e-3]
           + [f"update {n}" for n, e in upd.items() if not e <= 1e-1])
    if bad or mk["bad_grad"] or mp["bad_grad"]:
        fail(f"{path}: train step with kernels disagrees with the plain "
             f"versions in {len(bad)} places: {bad[:10]}")
    return {"aux_max_rel": aux[worst["aux"]],
            "norms_max_rel": norms[worst["norms"]],
            "grads_max_rel": grad[worst["grad"]],
            "updates_max_of_lr": upd[worst["upd"]], "noise_leaves": noise}


def with_chunks(captured):
    """Besides the compact kernels' captured inputs, the dense-chunk
    kernels' at the same constants, planes and cotangents, with the chunk
    cull of those constants (chunks.compute_chunk_info)."""
    from selfcorr_tpu_torch.ops.rasterizer.api import chunk_info
    out = dict(captured)
    for compact, chunk in (FWD_KERNELS, BWD_KERNELS):
        if compact in captured:
            consts, *rest = captured[compact]
            cs, sg = raster_args(compact, captured[compact])[3:5]
            out[chunk] = (consts, *chunk_info(consts, cs, *sg[:2]), *rest)
    return out


def report_main_path(path, captured):
    """Each kernel against its plain version at training path `path`'s
    first inputs; times and bounds there."""
    out = {}
    for name, args in captured.items():
        _, err, ok = hold(name, *args)
        if not ok:
            fail(f"{name} disagrees at the {path} path's inputs")
        if isinstance(err, dict):
            err = max(err.values())
        cost = (attn_costs(*args) if name == "dino_flash_attn"
                else raster_costs(name, *args))
        out[name] = c = dict(cost, max_abs_err=err)
        print(f"[report] {name} at the {path} path's inputs: kernel "
              f"{c['ms']} ms, plain {c['plain_ms']} ms, bound {c['bound_ms']}"
              f" ms ({c['bound_by']}), library {c.get('library_ms')} ms, "
              f"max|err| {c['max_abs_err']:.3g}", flush=True)
        if name == "raster_fused_bwd":
            print_b2(f"the {path} path's inputs", c)
        elif name in FWD_KERNELS:
            print_fwd("B1" if name == "raster_fused_fwd" else "B1'",
                      f"the {path} path's inputs", c)
        elif name == "dino_flash_attn":
            print_b3(f"the {path} path's inputs", c)
    return out


_CSRC = "selfcorr_tpu_torch/ops/rasterizer/csrc/"
_PALLAS = "selfcorr_tpu/ops/rasterizer/pallas_raster.py"
# kernel: (source, the TPU kernel it replaces, the training path whose run
# its row reports)
KERNELS = {
    "raster_fused_fwd": (_CSRC + "raster_fwd.cu", f"{_PALLAS}:806",
                         "train"),
    "raster_fused_bwd": (_CSRC + "raster_bwd.cu", f"{_PALLAS}:1177",
                         "train"),
    "raster_fused_fwd_chunk": (_CSRC + "raster_fwd_chunk.cu",
                               f"{_PALLAS}:730", "train_chunk"),
    "raster_fused_bwd_chunk": (_CSRC + "raster_bwd_chunk.cu",
                               f"{_PALLAS}:1117", "train_chunk"),
    "dino_flash_attn": ("selfcorr_tpu_torch/ops/csrc/flash_attn.cu",
                        "selfcorr_tpu/models/vit.py:72", "train"),
}


def main() -> int:
    t_start = time.time()
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    os.makedirs(OUT, exist_ok=True)
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.utils import cuda_build
    from selfcorr_tpu_torch.utils.device import set_fp32_precision
    set_fp32_precision()

    phase("build")
    t0 = time.time()
    cuda_build.build_all(list(KR.SOURCES.values()) + [A.SOURCE])
    KR.build()
    A.build()
    build_s = time.time() - t0
    built = [os.path.basename(p) for p in KR.SOURCES.values()]
    print(f"[build] {', '.join(built + ['flash_attn.cu'])} built (one nvcc "
          f"each, in parallel) and bound in {build_s:.2f} s", flush=True)
    usage = {}
    for src, log in cuda_build.LOGS.items():
        usage[os.path.basename(src)] = lines = [
            ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "arning"))]
        for ln in lines:
            print(f"[build] {os.path.basename(src)}: {ln}", flush=True)
    # the forwards' shared-memory loads: static counts in their SASS
    lds = {}
    for name in FWD_KERNELS:
        for fn, ops in cuda_build.sass_opcodes(KR.SOURCES[name]).items():
            lds[fn] = {op: n for op, n in ops.items()
                       if op.startswith("LDS")}
            print(f"[build] {fn}: shared-memory loads in its SASS {lds[fn]}",
                  flush=True)

    phase("B1 vs plain version")
    rng = np.random.RandomState(0)
    timings = kernel_phase(rng, dev)
    phase("B2 vs plain version")
    b2_timings = b2_phase(rng, dev)
    phase("B1', B2' vs plain versions, B1' vs B1")
    chunk_scenes = chunk_phase(rng, dev)
    phase(f"surface texels R={TEX_RES}: B1, B2, B1', B2' vs plain versions")
    texel_scenes = texel_phase(rng, dev)
    phase("B3 vs plain version")
    b3_cost = b3_phase(dev)

    phase("predict slice")
    cfg, predict_launches, captured = slice_phase()
    per_batch, fps, breakdown = fps_and_cpu_parity(cfg, smi)
    # every launch of the predict path, texture and depth-panel renders
    # alike, against the plain version on the same inputs
    errs, bad = {}, []
    for i, args in enumerate(captured):
        _, e, ok = hold("raster_fused_fwd", *args)
        errs = {n: max(v, errs.get(n, 0.0)) for n, v in e.items()}
        bad += [] if ok else [f"launch {i}"]
    print(f"[predict] {len(captured)} main-path launches vs plain, max|err| "
          + " ".join(f"{n}={e:.3g}" for n, e in errs.items()), flush=True)
    if bad:
        fail(f"kernel disagrees at the predict path's inputs: {bad}")
    consts = captured[0][0]
    predict_cost = raster_costs("raster_fused_fwd", *captured[0])
    print(f"[predict] B1 at the predict path's inputs: B={consts.shape[0]} "
          f"F={consts.shape[1]} S={captured[0][1]}; "
          f"{predict_cost['ops']} operations over pairs "
          f"{predict_cost['pairs']}", flush=True)
    print_fwd("predict", "B1 at the predict path's inputs", predict_cost)

    launches, captured, steps, parity = {"predict": predict_launches}, {}, \
        {}, {}
    for path, (_, _, compact, _) in TRAIN_PATHS.items():
        phase(f"training slice: {path}")
        trainer, launches[path], captured[path] = train_phase(path)
        # the trained state before the timed steps advance it further
        state = copy.deepcopy(trainer.state)
        with schedule(compact):
            steps[path] = train_timing(trainer, smi, path)
            parity[path] = step_kernels_vs_plain(
                state, *train_batch(trainer), trainer.cfg, path)
        del trainer, state
    print("[train] warm step at batch 32: " + "; ".join(
        f"{p} {ms:.2f} ms = {ips:.1f} imgs/s" for p, (ms, ips, _)
        in steps.items()) + f" on {smi}", flush=True)

    phase("report")
    # B1' and B2' with texels at the surface path's inputs too
    captured["train_surface"] = with_chunks(captured["train_surface"])
    main_costs = {p: report_main_path(p, c) for p, c in captured.items()}
    summary = {"card": smi, "build_s": build_s, "resource_usage": usage,
               "fwd_sass_lds": lds,
               "predict_ms_per_batch": per_batch * 1e3,
               "predict_fps_batch16": fps, "predict_profile": breakdown,
               "launches": launches,
               "b1_at_scenes": timings, "b1_predict_path": predict_cost,
               "b1_predict_path_max_abs_err": errs,
               "b2_at_scenes": b2_timings, "chunk_at_scenes": chunk_scenes,
               "texels_at_scenes": texel_scenes, "b3_trunk_shape": b3_cost,
               "train_step_ms": {p: s[0] for p, s in steps.items()},
               "train_imgs_per_s": {p: s[1] for p, s in steps.items()},
               "train_profile": {p: s[2] for p, s in steps.items()},
               "train_step_parity": parity, "train_paths": main_costs}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    rows = []
    for name, (src, replaces, path) in KERNELS.items():
        c = main_costs[path][name]
        row = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[path][name],
            "launches_by_path": {p: n.get(name, 0)
                                 for p, n in launches.items()},
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c.get("library_ms")}
        if name in main_costs["train_surface"] and name != "dino_flash_attn":
            t = main_costs["train_surface"][name]
            row[f"tex_res_{TEX_RES}"] = {k: t[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        rows.append(row)
    print(f"[done] every phase passed in {time.time() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
