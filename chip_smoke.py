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
              versions at the same scenes (a)-(c), B1' against B1 and B2'
              against B2 on the same constants, planes and cotangents
              (whether each pair is bit-identical is recorded), a second B2'
              launch bit-identical; B1 / B1' and B2 / B2' times side by
              side, B2' beside its bound with the pixels it tests (the
              mirror of its walk, kernel.bwd_visits) beside the covered
              pairs
  6. texels   B1, B2, B1', B2' with surface texels at R = 6 (K = 192)
              against their plain versions, second backward launches
              bit-identical, B1' == B1 and B2' == B2 recorded; B2' beside
              B2 and its bound at the laptop scene
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
 10. ckpt     checkpoint, resume and imports, at the compact path's width:
              (a) the entry point trains 2 steps saving each; a fresh Trainer
              over the same run directory resumes at step 2 and equals the
              saved state bit for bit on the card; its next step equals the
              first Trainer's third step (same batch and draws) bit for bit
              where two runs of that step from one state do, else within
              their difference (both under PyTorch's deterministic
              algorithms; the default algorithms' difference is printed);
              the checkpoint's bytes, save and restore times (median of 3);
              (b) a torchvision-named resnet18 and a DINO ViT-S/8 at the
              released shapes (grid 28, 12 blocks), made from the seed, go
              in through --resnet_init_path / --dino_init_path: the backbone
              and trunk hold the files' values (pos_embed resized to grid
              32), and one step is finite with B1, B2 and 9 B3 launched;
              (c) the predict entry point with --model_path <run>/ckpt: its
              model is the saved one bit for bit, its NOCS metrics finite,
              its panels launch B1. Every run directory starts empty, and
              the checkpoints and weight files are removed at the end
 11. report   every kernel held against its plain version at each training
              path's inputs (B1' and B2' also at the surface path's, texels
              and all)
 12. data     the dataset readers (images through Pillow) on fixtures
              written by data/fixtures.py into an emptied .work/fixtures,
              removed at the end: the image libraries found; the native box
              IoU built by g++ (timed); (a) Wild6D training at the compact
              path's width on 4 x 24 frames of 480 x 480, 3 steps (B1 = B2 =
              3, B3 = 27), the decode ms per file and crop ms per frame, ms
              per batch of 32 on one thread and through the TrainLoader
              alone (4, 8, 16 threads; 4 and 8 worker processes,
              --loader_processes), the bytes the process arm moves (the
              pickled reader each worker receives, a batch's packed items),
              the host's CPU (effective cores of 8 worker processes), the
              loop's wait on the loader per step (timed by a TrainLoader
              subclass patched into the loop, which also times a process
              pool's start-up), the warm step on the fixture beside phase
              9's synthetic one, and train_step alone and while a
              TrainLoader makes batches beside it (8 threads; 4 and 8
              processes) and beside 4 and 8 processes that only burn CPU,
              with a profile of steps alone and beside 8 threads and 8
              processes (device-busy against wall ms); then
              16 steps with --loader_processes and 16 with threads (B1 = B2
              = 16, B3 = 144 each): the loop's ms per iteration and its
              waits past the batches queued ahead; then the trainer's image
              log, 3 steps with --vis_freq 2 (B1 = 3 + 2, B2 = 3, B3 = 27 +
              9): the 20 image tags and the mean mesh's OBJ, every B1 launch
              at B = 2 (forward_vis, S = 256) and B3 launch at (2, 6, 1025,
              64) held against the plain versions and timed, _log_images
              timed; (b) the predict entry point with --eval --eval_nocs
              --vis_pred and every --visualize_* flag on the 2 x 6 test
              frames (six finite NOCS metrics, B1 twice a frame), every
              panel of every frame written (the 3D figure when matplotlib
              is installed), then a warm Tester.test() on a 2 x 96-frame
              split (12 full batches of 16): frames/s with and without its
              set-up, the loop's ms per batch on the loader and after it,
              beside predict_batch alone, valid frames only; the NOCS
              accumulation per sample with the native IoU beside scipy's;
              (c) NOCS (config/nocs/laptop.txt, use_occ): one step (B1, B2,
              9 B3), then --eval_nocs; (d) CUB (config/cub/cub.txt): one
              step (B1, B2, 9 B3), then --eval_cub --vis_pred (finite mIoU,
              kp@0.1, kp@0.2; B1 once for its one batch; the crop panels of
              its 8 birds and the keypoint triples of its 4 pairs). Each
              run's counts are zeroed just before and read just after, each
              training run's first B1, B2 and B3 inputs and every
              evaluation B1 launch held against the plain versions
 13. data parallel (selfcorr_tpu_torch/parallel) at the compact path's
              width: (i) the train entry point with --num_processes 1
              --process_id 0 --coordinator_address 127.0.0.1:<free port>,
              3 steps through an NCCL group of one (B1 = B2 = 3, B3 = 27,
              every all_mean_ in it); in a new group of one, one step
              through it against one without it from one state, batch and
              draws (bit for bit where two runs of the step are), the warm
              step with and without it in turns, all_mean_ alone over the
              gradients and BatchNorm statistics, a step's peak device
              memory; (ii) two ranks on cuda:0 over gloo (NCCL takes one
              rank a GPU), each a Trainer at batch 4 x 4 (the global 32):
              under the deterministic algorithms one two-rank step against
              the composite of the two single-rank steps on the ranks' rows
              (mean of gradients, aux losses and BatchNorm statistics, the
              clip, one AdamW step), the ranks' states equal; per rank its
              launches (B1 = B2 = 1, B3 = 9), its first B1, B2, B3 inputs
              held against the plain versions, its peak device memory and
              warm two-rank steps (gloo on one card, not a data-parallel
              rate); (iii) phase 12's Wild6D test split evaluated by two
              ranks on cuda:0 over gloo (8 rows each of the batch of 16)
              and by one: the six NOCS metrics equal. Then the fixtures
              are removed, and the kernel table's JSON line and the result
              line printed

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
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

if __name__ != "__mp_main__":
    # not in the loader's spawn-started workers, which re-import this file
    # as __mp_main__ and never touch torch
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
    the inputs (cloned) of its first call, or of every call for which
    select(*args) is true; the count stays the wrapper's."""

    def __init__(self, module, name, select=None):
        self.module, self.name, self.select = module, name, select
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def spy(*args):
            if (self.select(*args) if self.select is not None
                    else not self.calls):
                self.calls.append(tuple(clone(a) for a in args))
            return self.fn(*args)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def every(*_):
    return True


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


def visited_pixels(consts, s, sigma1, sigma2, chunks=()):
    """The pixels on which B2 (or, with chunks, B2') runs the cover test,
    from the mirror of its walk (kernel.bwd_visits, one image at a time on
    the constants' device), and the lanes of the 32-pixel steps of the walk
    over each face's padded box, which B2 and B2' take alike."""
    from selfcorr_tpu_torch.ops.rasterizer.kernel import bwd_visits
    pixels = lanes = 0
    for i in range(consts.shape[0]):
        box = bwd_visits(consts[i:i + 1], s, sigma1, sigma2)
        lanes += int(((box.sum(1) + 31) // 32 * 32).sum())
        if chunks:
            box = bwd_visits(consts[i:i + 1], s, sigma1, sigma2,
                             tuple(t[i:i + 1] for t in chunks))
        pixels += int(box.sum())
    return pixels, lanes


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
            consts, s, *sg[:2], chunks)
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


def print_b2(where, c, tag="B2"):
    """A backward's time beside its bound, and the pixels it tests beside
    the covered pairs."""
    print(f"[{tag}] {where}: kernel {c['ms']} ms, plain {c['plain_ms']} ms, "
          f"bound {c['bound_ms']} ms ({c['bound_by']}; "
          f"{100 * c['bound_ms'] / c['ms']:.1f}% of the bound; {c['ops']} "
          f"operations over pairs {c['pairs']}; {c['bytes']} bytes); pixels "
          f"tested {c['visited_pixels']} = "
          f"{c['visited_pixels'] / max(c['pairs']['cover'], 1):.3f}x the "
          f"{c['pairs']['cover']} covered pairs (lanes "
          f"{c['visited_lanes']})", flush=True)


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
    against B1 and B2' against B2 on the same sorted constants, planes and
    cotangents (bit-identical or not, recorded); a second B2' launch
    bit-identical; at the timed scenes the kernel times of both schedules
    side by side, B2' beside its bound with the pixels it tests."""
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
        b2args = (consts, planes, grads, s, *sg)
        same_b2 = torch.equal(kg, KR.raster_fused_bwd_cuda(*b2args))
        rec = {"fwd_max_abs_err": errs, "bwd_max_abs_err": err,
               "b1_bit_identical": same_b1, "bwd_repeat_bit_identical": again,
               "b2_bit_identical": same_b2,
               "chunks_visited": int(torch.stack(
                   [(cull[1] >> i) & 1 for i in range(32)]).sum())}
        print(f"[B1'/B2'] {name}: F={consts.shape[1]} B1' max|err| "
              + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
              + f"; B1' == B1 bit for bit: {same_b1}; B2' max|err| "
              f"{err:.3g}; B2' repeat bit-identical: {again}; B2' == B2 bit "
              f"for bit: {same_b2}; (tile, chunk) pairs visited "
              f"{rec['chunks_visited']}", flush=True)
        failures += ([] if ok else [f"{name}: B1' disagrees"]) \
            + ([] if ok_b else [f"{name}: B2' disagrees"]) \
            + ([] if again else [f"{name}: a second B2' launch differs"])
        if timed:
            c = raster_costs("raster_fused_bwd_chunk", *bargs)
            rec.update(
                b1_chunk_ms=time_ms(lambda: KR.raster_fused_fwd_chunk_cuda(
                    consts, *cull, s, *sg)),
                b1_ms=time_ms(lambda: KR.raster_fused_fwd_cuda(consts, s,
                                                               *sg)),
                b2_chunk=c,
                b2_ms=time_ms(lambda: KR.raster_fused_bwd_cuda(*b2args)))
            print(f"[B1'/B2'] {name}: B1' {rec['b1_chunk_ms']} ms vs B1 "
                  f"{rec['b1_ms']} ms; B2' {c['ms']} ms vs B2 "
                  f"{rec['b2_ms']} ms", flush=True)
            print_b2(name, c, "B2'")
        out[name] = rec
    if failures:
        fail("B1'/B2': " + "; ".join(failures))
    return out


TEX_RES = 6     # the JAX default n_tex_sample: K = 192


def texel_phase(rng, dev):
    """B1, B2, B1', B2' with random surface texels at R = TEX_RES against
    their plain versions: the laptop prior under 8 poses at S=256 and F=21
    at S=64; second backward launches bit-identical; B1' against B1 and B2'
    against B2 bit for bit (recorded); at the laptop scene B2' beside B2
    and its bound, with the pixels it tests."""
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.ops.rasterizer.api import chunk_info
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_plain
    sg, r = SIGMAS, TEX_RES
    cases = [("(b) laptop 8 poses B=8 S=256", *laptop_scene(rng, 8), 256,
              True),
             ("(c) F=21 S=64", *random_scene(rng, 1, 21), 64, False)]
    out, failures = {}, []
    for name, fv, st, ht, s, timed in cases:
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
            rec[kname]["out"] = ko
            failures += [] if ok else [f"{name}: {kname} disagrees"]
        fwd, fwd_c, bwd, bwd_c = (rec[n].pop("out")
                                  for n in FWD_KERNELS + BWD_KERNELS)
        rec["b1_chunk_b1_bit_identical"] = all(
            torch.equal(fwd[n], fwd_c[n]) for n in fwd)
        rec["b2_chunk_b2_bit_identical"] = torch.equal(bwd, bwd_c)
        print(f"[texels] {name} R={r} K={consts.shape[2]}: " + "; ".join(
            f"{n} {v}" for n, v in rec.items()), flush=True)
        if timed:
            c = raster_costs("raster_fused_bwd_chunk", consts, *cull, planes,
                             grads, s, *sg, r)
            rec["b2_chunk"] = c
            rec["b2_ms"] = time_ms(lambda: KR.raster_fused_bwd_cuda(
                consts, planes, grads, s, *sg, r))
            print(f"[texels] {name}: B2' {c['ms']} ms vs B2 {rec['b2_ms']} "
                  f"ms", flush=True)
            print_b2(f"{name} R={r}", c, "B2'")
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

NOCS_KEYS = ("iou@25", "iou@50", "5deg2cm", "5deg5cm", "10deg2cm",
             "10deg5cm")
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
    with Capture(KR, "raster_fused_fwd_cuda", every) as cap:
        reset_launches()
        t0 = time.time()
        results = predict.main(["predict"] + run_args)
        torch.cuda.synchronize()
        launches = read_launches()
    wall = time.time() - t0
    print(f"[slice] predict.main wall {wall:.2f} s (cold: data, first "
          f"launches); kernel launches {launches}", flush=True)
    for k in NOCS_KEYS:
        print(f"[slice] {k}: {results.get(k)}")
    if not all(k in results and math.isfinite(results[k])
               for k in NOCS_KEYS):
        fail(f"NOCS metrics missing or not finite: {results}")
    if results.get("count") != 12:
        fail(f"expected 12 valid samples, got {results.get('count')}")
    vis = os.path.join(OUT, "predict", "vis")
    pngs = sorted(p for p in os.listdir(vis) if p.endswith(".png"))
    print(f"[slice] {len(pngs)} panels in {vis}")
    if len(pngs) != 48:
        fail(f"expected 48 panels (12 samples x the frame, depth, tex, "
             f"mask), got {len(pngs)}")
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
                         "--checkpoint_dir", OUT, "--name", fresh_run(path)]
    with schedule(compact), contextlib.ExitStack() as stack:
        caps = {n: stack.enter_context(Capture(KR, f"{n}_cuda"))
                for n in raster}
        caps["dino_flash_attn"] = stack.enter_context(
            Capture(A, "flash_attention_cuda"))
        made = stack.enter_context(timed_loaders(loop, "TrainLoader"))
        reset_launches()
        t0 = time.time()
        trainer = loop.main(["train"] + args)
        torch.cuda.synchronize()
        launches = read_launches()
    wall = time.time() - t0
    drop_checkpoints()
    print(f"[{path}] loop.main {steps} steps, wall {wall:.2f} s (cold: "
          f"data, first launches, the final checkpoint); kernel launches "
          f"{launches}", flush=True)
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


def fresh_run(name: str) -> str:
    """An empty run directory OUT/name (the Trainer resumes from any
    checkpoint it finds there); returns name."""
    shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
    return name


def drop_checkpoints():
    """Remove every checkpoint directory and weight file under OUT, so that
    none outlives the phase that read it."""
    for d, dirs, files in os.walk(OUT):
        if "ckpt" in dirs:
            shutil.rmtree(os.path.join(d, "ckpt"))
            dirs.remove("ckpt")
        for f in files:
            if f.endswith(".pth"):
                os.remove(os.path.join(d, f))


def train_batch(trainer):
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.train.loop import (make_train_dataset,
                                               step_generator)
    from selfcorr_tpu_torch.data.loader import compress_batch_host
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

    class FixedTrunk:       # the trunk's features, computed once
        dtype = torch.float32

        def __call__(self, img):
            return feats
    lrs = state.optimizer.lrs(0)
    lr_of = {n: lrs[g] for g, ps in state.optimizer.groups.items()
             for n, _ in ps}
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    runs = {}
    for route in ("kernels", "plain"):
        st = copy.deepcopy(state)
        st.step = 0
        st.dino = FixedTrunk()
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


# ---------------------------------------------------------------------------
# checkpoint, resume and imports
# ---------------------------------------------------------------------------

def state_tensors(state) -> dict:
    """A copy of every tensor of a train state by name (model, trunk, each
    AdamW moment and step count) and TrainState.step."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"dino.{k}": v for k, v in state.dino.state_dict().items()})
    for pid, st in state.optimizer.adamw.state_dict()["state"].items():
        out.update({f"adamw.{pid}.{k}": v for k, v in st.items()})
    out = {k: v.clone() for k, v in out.items()}
    out["step"] = torch.tensor(state.step)
    return out


def max_diff(x: dict, y: dict) -> float:
    return max(float((x[k].double() - y[k].double()).abs().max()) for k in x)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's too) inside the block;
    an op that has none warns and runs as it would."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def stepped(state, batch, draws, cfg, group=None) -> dict:
    """One train step from a copy of `state` (through the process group
    `group`, if given): the copy's tensors and the step's metrics."""
    from selfcorr_tpu_torch.train.step import train_step
    st = copy.deepcopy(state)
    m = train_step(st, batch, draws, cfg, group)
    torch.cuda.synchronize()
    return {**state_tensors(st),
            **{f"metric.{k}": v.reshape(1) for k, v in m.items()}}


def resume_check(card: str) -> dict:
    """(a): train 2 steps through the entry point saving each, resume in a
    fresh Trainer, compare; the checkpoint's bytes, save and restore
    times."""
    import importlib.util
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.train import loop
    from selfcorr_tpu_torch.utils import checkpoint as ckpt
    args = TRAIN_ARGS + ["--total_iters", "2", "--save_freq", "1",
                         "--checkpoint_dir", OUT, "--name",
                         fresh_run("resume")]
    print("[ckpt] installed: " + ", ".join(
        f"{m} {importlib.util.find_spec(m) is not None}"
        for m in ("tensorboard", "tensorflow")), flush=True)
    reset_launches()
    first = loop.main(["train"] + args)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"raster_fused_fwd": 2, "raster_fused_bwd": 2,
            "raster_fused_fwd_chunk": 0, "raster_fused_bwd_chunk": 0,
            "dino_flash_attn": 2 * ATTN_PER_STEP}
    if launches != want:
        fail(f"resume run: launches {launches}, expected {want}")
    steps = sorted(os.listdir(first.ckpt_dir))
    if steps != ["1", "2"]:
        fail(f"--save_freq 1 over 2 steps wrote checkpoints {steps}")
    nbytes = os.path.getsize(ckpt.checkpoint_file(first.ckpt_dir, 2))
    saved = state_tensors(first.state)

    second = loop.Trainer(first.cfg)
    got = state_tensors(second.state)
    bad = [k for k in saved if got[k].device != saved[k].device
           or not torch.equal(got[k], saved[k])]
    print(f"[ckpt] the fresh Trainer resumed at step {second.state.step}: "
          f"{len(saved)} tensors (model, trunk, AdamW moments and steps, "
          f"step), {len(bad)} differ from the saved state", flush=True)
    if second.state.step != 2 or bad:
        fail(f"the restored state differs from the saved one: {bad[:10]}")

    cfg = first.cfg
    batch, _ = train_batch(first)
    draws = draw_step(loop.step_generator(cfg.seed, 2), cfg,
                      batch["img"].shape[0])
    noise_default = max_diff(stepped(first.state, batch, draws, cfg),
                             stepped(first.state, batch, draws, cfg))
    with deterministic():
        noise = max_diff(stepped(first.state, batch, draws, cfg),
                         stepped(first.state, batch, draws, cfg))
        straight = stepped(first.state, batch, draws, cfg)
        resumed = stepped(second.state, batch, draws, cfg)
    err = max_diff(resumed, straight)
    print(f"[ckpt] step 3, resumed vs straight: max|diff| {err:.3g} over "
          f"every parameter, buffer, moment and metric; two runs of that "
          f"step from one state differ by {noise:.3g} under the "
          f"deterministic algorithms, {noise_default:.3g} under the default "
          f"ones", flush=True)
    if not (err == 0.0 if noise == 0.0 else err <= noise):
        fail(f"the step after the resume is {err:.3g} from the straight "
             f"run's, beyond the step's own noise {noise:.3g}")

    tdir = os.path.join(OUT, "resume", "ckpt", "timing")
    save_s, restore_s = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ckpt.save_state(tdir, first.state, 100 + i)
        save_s.append(time.time() - t0)
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ckpt.restore_state(tdir, second.state, 100 + i)
        torch.cuda.synchronize()
        restore_s.append(time.time() - t0)
    save_ms = statistics.median(save_s) * 1e3
    restore_ms = statistics.median(restore_s) * 1e3
    print(f"[ckpt] checkpoint {nbytes} bytes; save (state_dict, torch.save, "
          f"fsync, rename) median {save_ms:.1f} ms of "
          f"{', '.join(f'{t * 1e3:.1f}' for t in save_s)}; restore "
          f"(torch.load of a file just written, load_state_dict on the card) "
          f"median {restore_ms:.1f} ms of "
          f"{', '.join(f'{t * 1e3:.1f}' for t in restore_s)} on {card}",
          flush=True)
    return {"first": first, "launches": launches, "bytes": nbytes,
            "save_ms": save_ms, "restore_ms": restore_ms,
            "save_ms_all": [t * 1e3 for t in save_s],
            "restore_ms_all": [t * 1e3 for t in restore_s],
            "resume_max_diff": err, "step_noise": noise,
            "step_noise_default": noise_default}


def released_files(rng, model, dino):
    """A torchvision-named resnet18 state dict with its fc head, and a DINO
    ViT-S/8 state dict at the released shapes (pos_embed (1, 785, 384), 12
    blocks, the final norm), of seeded weights, on the CPU."""
    def draw(shape, name):
        if name.endswith("num_batches_tracked"):
            return torch.tensor(0)
        if name.endswith(("running_var", "norm1.weight", "norm2.weight")):
            return torch.tensor(rng.uniform(0.5, 1.5, shape),
                                dtype=torch.float32)
        return torch.tensor(rng.standard_normal(shape) * 0.02,
                            dtype=torch.float32)
    resnet = {k: draw(v.shape, k) for k, v in
              model.encoder.backbone.resnet.state_dict().items()}
    resnet["fc.weight"] = draw((1000, 512), "fc.weight")
    resnet["fc.bias"] = draw((1000,), "fc.bias")
    shapes = {k: v.shape for k, v in dino.state_dict().items()}
    for i in (10, 11):
        shapes.update({k.replace("blocks.0.", f"blocks.{i}."): v
                       for k, v in shapes.items()
                       if k.startswith("blocks.0.")})
    shapes.update({"pos_embed": (1, 785, 384), "norm.weight": (384,),
                   "norm.bias": (384,)})
    return resnet, {k: draw(v, k) for k, v in shapes.items()}


def import_check(first) -> dict:
    """(b): the released files' layout, drawn from the run's seed, through
    --resnet_init_path and --dino_init_path, then one train step through
    the loop."""
    import torch.nn.functional as F
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.train import loop
    resnet, vit = released_files(np.random.RandomState(first.cfg.seed),
                                 first.state.model, first.state.dino)
    os.makedirs(os.path.join(OUT, fresh_run("imports")))
    paths = [os.path.join(OUT, "imports", n)
             for n in ("resnet18.pth", "dino_vits8.pth")]
    torch.save(resnet, paths[0])
    torch.save(vit, paths[1])
    cfg = parse_args(TRAIN_ARGS + [
        "--total_iters", "1", "--checkpoint_dir", OUT, "--name", "imports",
        "--resnet_init_path", paths[0], "--dino_init_path", paths[1]])
    trainer = loop.Trainer(cfg)
    got_r = trainer.state.model.encoder.backbone.resnet.state_dict()
    bad = [k for k, v in got_r.items() if not k.endswith(
        "num_batches_tracked") and not torch.equal(v.cpu(), resnet[k])]
    got_d = trainer.state.dino.state_dict()
    pos, g = vit["pos_embed"], cfg.img_size // 8
    grid = F.interpolate(
        pos[0, 1:].reshape(28, 28, 384).permute(2, 0, 1)[None],
        size=(g, g), mode="bicubic")[0]
    want_pos = torch.cat([pos[:, :1], grid.permute(1, 2, 0).reshape(
        1, g * g, 384)], 1)
    bad += [k for k, v in got_d.items() if not torch.equal(
        v.cpu(), want_pos if k == "pos_embed" else vit[k])]
    print(f"[imports] backbone ({len(got_r)} tensors) and trunk "
          f"({len(got_d)}; pos_embed {tuple(got_d['pos_embed'].shape)} from "
          f"the file's {tuple(pos.shape)}) hold the files' values: "
          f"{len(bad)} differ", flush=True)
    if bad:
        fail(f"imported weights differ from the files: {bad[:10]}")
    reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    launches = read_launches()
    vals = trainer.logged[-1][1] if trainer.logged else {}
    print(f"[imports] one step from the imported weights: total_loss "
          f"{vals.get('total_loss')}, bad_grad {vals.get('bad_grad')}; "
          f"kernel launches {launches}", flush=True)
    want = {"raster_fused_fwd": 1, "raster_fused_bwd": 1,
            "raster_fused_fwd_chunk": 0, "raster_fused_bwd_chunk": 0,
            "dino_flash_attn": ATTN_PER_STEP}
    if (launches != want or not vals or vals["bad_grad"] != 0.0
            or not all(math.isfinite(v) for v in vals.values())):
        fail(f"the step from imported weights: launches {launches} "
             f"(expected {want}), metrics {vals}")
    return {"launches": launches, "metrics": vals}


def predict_from_checkpoint(first) -> dict:
    """(c): the predict entry point with --model_path <run>/ckpt."""
    from selfcorr_tpu_torch import predict
    from selfcorr_tpu_torch.eval import tester as TS
    from selfcorr_tpu_torch.utils import checkpoint as ckpt
    want = ckpt.restore_raw(first.ckpt_dir)["model"]
    made = []
    init = TS.Tester.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    TS.Tester.__init__ = keep
    try:
        reset_launches()
        results = predict.main(["predict"] + SLICE_ARGS + [
            "--checkpoint_dir", OUT, "--name", fresh_run("predict_ckpt"),
            "--model_path", first.ckpt_dir])
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        TS.Tester.__init__ = init
    got = made[0].model.state_dict()
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
    keys = ("iou@25", "iou@50", "5deg2cm", "5deg5cm", "10deg2cm", "10deg5cm")
    print(f"[predict_ckpt] --model_path {first.ckpt_dir}: {len(bad)} of "
          f"{len(want)} model tensors differ from the checkpoint's; "
          + " ".join(f"{k} {results.get(k)}" for k in keys)
          + f"; kernel launches {launches}", flush=True)
    if bad or sorted(got) != sorted(want):
        fail(f"the predict path's model is not the checkpoint's: {bad[:10]}")
    if not all(k in results and math.isfinite(results[k]) for k in keys):
        fail(f"NOCS metrics from the checkpoint missing or not finite: "
             f"{results}")
    if launches["raster_fused_fwd"] == 0:
        fail("predict from the checkpoint never launched raster_fused_fwd")
    return {"launches": launches, "metrics": {k: results[k] for k in keys}}


def checkpoint_phase(card: str) -> dict:
    try:
        res = resume_check(card)
        first = res.pop("first")
        res["imports"] = import_check(first)
        res["predict"] = predict_from_checkpoint(first)
    finally:
        drop_checkpoints()
    return res


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
        if name in BWD_KERNELS:
            print_b2(f"the {path} path's inputs", c,
                     "B2" if name == "raster_fused_bwd" else "B2'")
        elif name in FWD_KERNELS:
            print_fwd("B1" if name == "raster_fused_fwd" else "B1'",
                      f"the {path} path's inputs", c)
        elif name == "dino_flash_attn":
            print_b3(f"the {path} path's inputs", c)
    return out


# ---------------------------------------------------------------------------
# phase 12: the dataset readers on fixtures
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(ROOT, ".work", "fixtures")
W6D_RAW = 480           # Wild6D-laptop fixture: raw frames 480 x 480
RATE_FRAMES = 96        # per test video of the evaluation-rate split: 2 x
                        # 96 frames, 12 full batches of 16
LONG_STEPS = 16         # a run long enough to drain the loader's queue
NOCS_HW = (480, 640)    # the REAL275 frame size
CUB_HW = (480, 640)


def image_probe():
    """Which image libraries this machine has: the readers use Pillow."""
    import importlib.util
    from PIL import Image, features
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("PIL", "torchvision", "cv2")}
    print(f"[data] image probe: Pillow {Image.__version__} (JPEG "
          f"{features.check('jpg')}, libjpeg-turbo "
          f"{features.check('libjpeg_turbo')}); installed "
          f"{found}; the readers decode with Pillow", flush=True)
    return dict(found, pillow=Image.__version__)


def write_fixtures() -> dict:
    """The three fixture trees under an emptied FIXTURES; their paths."""
    from selfcorr_tpu_torch.data import fixtures as FX
    shutil.rmtree(FIXTURES, ignore_errors=True)
    t0 = time.time()
    w6d = os.path.join(FIXTURES, "wild6d")
    train_root, test_root = FX.wild6d_tree(
        w6d, n_train_videos=4, n_test_videos=2, frames_per_video=24,
        test_frames=6, raw_size=W6D_RAW)
    FX.write_list(train_root, os.path.join(w6d, "train.txt"))
    FX.write_list(test_root, os.path.join(w6d, "test.txt"))
    rates = os.path.join(FIXTURES, "wild6d_rates")
    _, rates_root = FX.wild6d_tree(
        rates, n_train_videos=0, n_test_videos=2, test_frames=RATE_FRAMES,
        raw_size=W6D_RAW)
    FX.write_list(rates_root, os.path.join(rates, "test.txt"))
    nocs_root = os.path.join(FIXTURES, "nocs", "real")
    nocs_list = FX.nocs_tree(nocs_root, hw=NOCS_HW)
    cub = {s: os.path.join(FIXTURES, f"cub_{s}", "cub") for s in
           ("train", "test")}
    cub_lists = {s: FX.cub_tree(r, per_class=3 if s == "train" else 4,
                                hw=CUB_HW, split=s) for s, r in cub.items()}
    print(f"[data] fixtures written in {time.time() - t0:.2f} s: Wild6D "
          f"4 x 24 train / 2 x 6 test frames and a 2 x {RATE_FRAMES} "
          f"evaluation-rate split at {W6D_RAW}^2, NOCS 3 frames "
          f"at {NOCS_HW}, CUB 2 x 3 train / 2 x 4 test birds at {CUB_HW}",
          flush=True)
    return {"w6d_train": ["--dataset_path", train_root, "--train_list",
                          os.path.join(w6d, "train.txt")],
            "w6d_test": ["--test_dataset_path", test_root + "/",
                         "--test_list", os.path.join(w6d, "test.txt")],
            "w6d_rates": ["--test_dataset_path", rates_root + "/",
                          "--test_list", os.path.join(rates, "test.txt")],
            "nocs": ["--dataset_path", nocs_root, "--train_list", nocs_list,
                     "--test_dataset_path", nocs_root, "--test_list",
                     nocs_list],
            "cub_train": ["--dataset_path", cub["train"], "--train_list",
                          cub_lists["train"]],
            "cub_test": ["--test_dataset_path", cub["test"], "--test_list",
                         cub_lists["test"]]}


def loading_costs(trainer) -> dict:
    """Host costs of the Wild6D fixture's training data: decode ms per file
    and crop ms per frame (medians over every training frame), ms per batch
    of 32 on one thread, and through the TrainLoader alone: its threads at
    4, 8 and 16, its worker processes (--loader_processes) at 4 and 8; and
    the bytes the process arm moves between processes: the pickled dataset
    each worker receives at its start, and what the workers send back for
    one batch."""
    import pickle
    from selfcorr_tpu_torch.data.crops import crop_frame
    from selfcorr_tpu_torch.data.loader import stack_items
    from selfcorr_tpu_torch.train.loop import make_train_dataset
    from selfcorr_tpu_torch.data.loader import compress_batch_host
    from selfcorr_tpu_torch.utils import imageio as io
    cfg = trainer.cfg
    ds = make_train_dataset(cfg)
    times = {"jpeg": [], "mask_png": [], "depth_png": [], "crop": []}

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        times[key].append((time.perf_counter() - t0) * 1e3)
        return out

    for v in ds.videos.videos:
        for img_p, mask_p, depth_p in zip(v["imgs"], v["masks"],
                                          v["depths"]):
            img = timed("jpeg", io.read_rgb, img_p)
            mask = timed("mask_png", io.read_gray, mask_p) > 0
            depth = timed("depth_png", io.read_unchanged,
                          depth_p).astype(np.float32)
            timed("crop", crop_frame, img, mask, depth,
                  np.array([576.0, 576.0], np.float32),
                  np.array([240.0, 240.0], np.float32), cfg.img_size,
                  np.array([1.35, 1.35]))
    med = {k: statistics.median(t) for k, t in times.items()}
    seq = []
    for step in range(3):
        t0 = time.perf_counter()
        compress_batch_host(stack_items([ds.load_item(*a)
                                         for a in ds.sample_plan(step)]))
        seq.append((time.perf_counter() - t0) * 1e3)
    pooled = {}
    for arm, n in LOADER_ARMS + (("threads", 4), ("threads", 16)):
        pooled[f"{arm}_{n}"] = loader_alone_ms(
            cfg.replace(loader_processes=arm == "processes"),
            make_train_dataset(cfg), n)
    # what a worker receives at its start; a batch's packed items, pickled
    # and as arrays
    blob = pickle.dumps((make_train_dataset(cfg), compress_batch_host),
                        pickle.HIGHEST_PROTOCOL)
    items = [compress_batch_host(ds.load_item(*a))
             for a in ds.sample_plan(0)]
    pickled = sum(len(pickle.dumps(it, pickle.HIGHEST_PROTOCOL))
                  for it in items)
    sent_back = sum(np.asarray(v).nbytes for it in items
                    for v in it.values())
    out = {f"{k}_ms": v for k, v in med.items()}
    out.update(files=len(times["jpeg"]), batch_ms_one_thread=seq,
               batch_ms_loader=pooled, dataset_bytes_per_worker=len(blob),
               batch_bytes_from_workers=sent_back,
               batch_bytes_pickled=pickled)
    print(f"[data] decode ms per file (median of {out['files']} each): JPEG "
          f"{med['jpeg']:.3f}, mask PNG {med['mask_png']:.3f}, depth PNG "
          f"{med['depth_png']:.3f}; crop {med['crop']:.3f} ms per frame; "
          f"a batch of 32 on one thread "
          f"{', '.join(f'{t:.1f}' for t in seq)} ms; through the "
          f"TrainLoader alone, ms per batch: "
          + ", ".join(f"{k} {t:.1f}" for k, t in pooled.items())
          + f"; the process arm sends each worker {len(blob)} bytes at its "
          f"start; a batch's packed items are {sent_back} bytes "
          f"({pickled} pickled)", flush=True)
    return out


@contextlib.contextmanager
def timed_loaders(module, name: str):
    """Replaces the loader class module.<name> with a subclass that times
    its construction (a process pool's start-up), and, per batch, the
    consumer's wait in next() and the rest of its iteration (the loop's
    step, or the tester's predict and metrics), and the moment its
    constructor returned; yields the list of loaders made meanwhile. The
    loop and the tester themselves keep no timings."""
    base = getattr(module, name)
    made = []

    class Timed(base):
        def __init__(self, *a, **k):
            t0 = time.perf_counter()
            super().__init__(*a, **k)
            self.built = time.perf_counter()
            self.startup_s = self.built - t0
            self.waits, self.walls = [], []
            made.append(self)

        def __iter__(self):
            ready = time.perf_counter()
            for batch in super().__iter__():
                got = time.perf_counter()
                self.waits.append(got - ready)
                yield batch
                ready = time.perf_counter()
                self.walls.append(ready - got)

    setattr(module, name, Timed)
    try:
        yield made
    finally:
        setattr(module, name, base)


# the TrainLoader arms train_step is timed beside: (arm, threads or worker
# processes)
LOADER_ARMS = (("threads", 8), ("processes", 4), ("processes", 8))


@contextlib.contextmanager
def loader_beside(cfg, dataset, workers: int, batches: int):
    """A TrainLoader of `workers` threads, or worker processes with
    cfg.loader_processes, making `batches` batches of `dataset`, its first
    batch already taken; yields a function that takes (and drops) the next
    batch, as the loop takes them."""
    from selfcorr_tpu_torch.data.loader import TrainLoader
    from selfcorr_tpu_torch.data.loader import compress_batch_host
    loader = TrainLoader(dataset, cfg.replace(total_iters=batches,
                                              num_workers=workers),
                         host_transform=compress_batch_host)
    it = iter(loader)
    next(it)
    try:
        yield lambda: next(it)
    finally:
        loader.close()


def loader_alone_ms(cfg, dataset, workers: int, batches: int = 6) -> float:
    """ms per batch of a TrainLoader of `workers` threads (or processes,
    with cfg.loader_processes) over `dataset`, nothing else running, its
    first batch left out."""
    from selfcorr_tpu_torch.data.loader import TrainLoader
    from selfcorr_tpu_torch.data.loader import compress_batch_host
    loader = TrainLoader(dataset, cfg.replace(total_iters=batches + 1,
                                              num_workers=workers),
                         host_transform=compress_batch_host)
    try:
        it = iter(loader)
        next(it)
        t0 = time.perf_counter()
        got = sum(1 for _ in it)
        return (time.perf_counter() - t0) * 1e3 / got
    finally:
        loader.close()


def step_ms(trainer, take=None, reps: int = 8) -> float:
    """Median warm train_step ms on one uploaded batch of the trainer's
    data, the loading excluded; `take`, when given, is called before each
    step (a loader_beside making batches meanwhile)."""
    from selfcorr_tpu_torch.train.step import train_step
    cfg = trainer.cfg
    batch, draws = train_batch(trainer)
    train_step(trainer.state, batch, draws, cfg)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if take is not None:
            take()
        t0 = time.time()
        train_step(trainer.state, batch, draws, cfg)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def burners(workers: int):
    """`workers` processes running pure-Python loops while the block runs:
    the readers' load on the cores without their memory traffic."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        pool.map(_burn, [1000] * workers, chunksize=1)      # all started
        pool.map_async(_burn, [200_000_000] * workers, chunksize=1)
        yield
    finally:
        pool.terminate()
        pool.join()


def step_beside_loaders(trainer, card: str, reps: int = 8) -> dict:
    """train_step alone and while a TrainLoader makes batches beside it, in
    each of LOADER_ARMS, and beside 4 and 8 processes that only burn CPU
    (burners); a profile of steps alone and beside the 8-thread and the
    8-process loader: device-busy ms against wall ms per step."""
    from selfcorr_tpu_torch.train.loop import make_train_dataset
    from selfcorr_tpu_torch.train.step import train_step
    cfg = trainer.cfg
    out = {"alone": step_ms(trainer, reps=reps)}
    for arm, n in LOADER_ARMS:
        with loader_beside(cfg.replace(loader_processes=arm == "processes"),
                           make_train_dataset(cfg), n, reps + 2) as take:
            out[f"{arm}_{n}"] = step_ms(trainer, take, reps)
    for n in (4, 8):
        with burners(n):
            out[f"burners_{n}"] = step_ms(trainer, reps=reps)
    batch, draws = train_batch(trainer)

    def step(take=None):
        if take is not None:
            take()
        train_step(trainer.state, batch, draws, cfg)
        torch.cuda.synchronize()

    prof = {"alone": profile_calls(step, 6, "w6d_train train_step alone",
                                   "w6d_step_alone_profile.txt")}
    for arm in ("threads", "processes"):
        with loader_beside(cfg.replace(loader_processes=arm == "processes"),
                           make_train_dataset(cfg), 8, 8) as take:
            prof[arm] = profile_calls(
                lambda: step(take), 6,
                f"w6d_train train_step beside 8 loader {arm}",
                f"w6d_step_{arm}_profile.txt")
    out["profile"] = {k: {"wall_ms": p["wall_ms"],
                          "device_busy_ms": p["device_busy_ms"]}
                      for k, p in prof.items()}
    print(f"[w6d_train] warm train_step ms (median of {reps}) alone and "
          f"beside a TrainLoader making batches: " + ", ".join(
              f"{k} {v:.2f}" for k, v in out.items() if k != "profile")
          + "; profiled, wall / device busy ms per step: " + ", ".join(
              f"{k} {p['wall_ms']:.2f} / {p['device_busy_ms']:.2f}"
              for k, p in out["profile"].items()) + f" on {card}",
          flush=True)
    return out


def _burn(n: int) -> float:
    """Pure-Python work, in a worker process: its own seconds."""
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i * i
    return time.perf_counter() - t0


def cpu_capacity(workers: int = 8, n: int = 4_000_000) -> dict:
    """The CPU this host gives worker processes: the wall time of one
    process running a pure-Python loop, and of `workers` processes running
    it at once; effective cores = workers x one / all. Also the cores and
    the cgroup quota as this process sees them."""
    import multiprocessing

    def read(path):
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return None

    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pool.map(_burn, [1000] * workers, chunksize=1)      # all started
        t0 = time.perf_counter()
        pool.map(_burn, [n])
        one = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool.map(_burn, [n] * workers, chunksize=1)
        every_s = time.perf_counter() - t0
    out = {"cpu_count": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0)),
           "cgroup_cpu_max": read("/sys/fs/cgroup/cpu.max"),
           "one_s": one, "all_s": every_s,
           "effective_cores": workers * one / every_s}
    print(f"[data] CPU: {out['cpu_count']} cores, {out['affinity']} in the "
          f"affinity set, cgroup cpu.max {out['cgroup_cpu_max']}; a "
          f"pure-Python loop takes {one:.3f} s in one worker process and "
          f"{every_s:.3f} s in each of {workers} at once: "
          f"{out['effective_cores']:.2f} effective cores", flush=True)
    return out


VIS_STEPS, VIS_FREQ = 3, 2      # one image log, at step 2


class ImageLog:
    """A writer that forwards its calls and keeps each add_image's tag,
    shape, dtype and step."""

    def __init__(self, writer):
        self.writer, self.images = writer, []

    def add_image(self, tag, img, step, **kw):
        self.images.append((tag, img.shape, str(img.dtype), step))
        self.writer.add_image(tag, img, step, **kw)

    def __getattr__(self, name):
        return getattr(self.writer, name)


def vis_train(tag: str, flagfile: str, data_args, card: str) -> dict:
    """The training entry point with --vis_freq 2 over 3 steps, launch
    counts zeroed just before and read just after: B1 once a step and
    twice in the image log (forward_vis at B = 2), B2 once a step, B3 9
    times a step and 9 in the log. Every B1 launch at B = 2 and every B3
    launch at batch 2 held against the plain versions, the first of each
    timed beside its bound; the image tags (20, with depth) and the mean
    mesh's OBJ checked; _log_images timed (synchronized)."""
    from unittest import mock
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.mesh_ops import load_obj
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.train import loop

    def two(*args):
        return args[0].shape[0] == 2

    run = fresh_run(tag)
    args = ["--flagfile", flagfile, *data_args, "--total_iters",
            str(VIS_STEPS), "--vis_freq", str(VIS_FREQ),
            "--batch_log_interval", "1", "--checkpoint_dir", OUT, "--name",
            run]
    writers, log_ms = [], []
    make_writer, log_images = loop.make_writer, loop.Trainer._log_images

    def logged_writer(run_dir):
        writers.append(ImageLog(make_writer(run_dir)))
        return writers[-1]

    def timed_log(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log_images(self, *a)
        torch.cuda.synchronize()
        log_ms.append((time.perf_counter() - t0) * 1e3)

    with contextlib.ExitStack() as stack:
        b1 = stack.enter_context(Capture(KR, "raster_fused_fwd_cuda", two))
        b3 = stack.enter_context(Capture(A, "flash_attention_cuda", two))
        stack.enter_context(mock.patch.object(loop, "make_writer",
                                              logged_writer))
        stack.enter_context(mock.patch.object(loop.Trainer, "_log_images",
                                              timed_log))
        reset_launches()
        trainer = loop.main(["train"] + args)
        torch.cuda.synchronize()
        launches = read_launches()
    drop_checkpoints()
    logs = VIS_STEPS // VIS_FREQ
    want = {n: 0 for n in launches}
    want.update(raster_fused_fwd=VIS_STEPS + 2 * logs,
                raster_fused_bwd=VIS_STEPS,
                dino_flash_attn=ATTN_PER_STEP * (VIS_STEPS + logs))
    if launches != want:
        fail(f"{tag}: launches {launches}, expected {want}")
    s = trainer.cfg.img_size
    images = writers[0].images
    shapes = {(shape, dtype, step) for _, shape, dtype, step in images}
    if len(images) != 20 * logs or shapes != {((s, s, 3), "uint8",
                                               VIS_FREQ)}:
        fail(f"{tag}: image log {images}")
    verts, _ = load_obj(os.path.join(OUT, run,
                                     f"{VIS_FREQ}-iter-mean-mesh.obj"))
    if verts.shape != tuple(trainer.state.model.mesh.mean_v.shape):
        fail(f"{tag}: the mean-mesh OBJ holds {verts.shape} vertices")
    if len(b1.calls) != 2 * logs or len(b3.calls) != ATTN_PER_STEP * logs:
        fail(f"{tag}: captured {len(b1.calls)} B1 and {len(b3.calls)} B3 "
             f"launches at batch 2")
    errs = {}
    for name, cap in (("raster_fused_fwd", b1), ("dino_flash_attn", b3)):
        for c in cap.calls:
            _, err, ok = hold(name, *c)
            if not ok:
                fail(f"{tag}: {name} at batch 2 disagrees with its plain "
                     f"version ({err})")
            err = max(err.values()) if isinstance(err, dict) else err
            errs[name] = max(errs.get(name, 0.0), err)
    costs = {"raster_fused_fwd": raster_costs("raster_fused_fwd",
                                              *b1.calls[0]),
             "dino_flash_attn": attn_costs(*b3.calls[0])}
    consts, q = b1.calls[0][0], b3.calls[0][0]
    print(f"[{tag}] {VIS_STEPS} steps with --vis_freq {VIS_FREQ}: launches "
          f"{launches}; {len(images)} image tags at step {VIS_FREQ}, the "
          f"mean mesh's OBJ; _log_images "
          f"{', '.join(f'{t:.2f}' for t in log_ms)} ms; B1 at B="
          f"{consts.shape[0]} S={b1.calls[0][1]} held ({len(b1.calls)} "
          f"launches, max|err| {errs['raster_fused_fwd']:.3g}): "
          f"{costs['raster_fused_fwd']['ms']:.4f} ms, bound "
          f"{costs['raster_fused_fwd']['bound_ms']:.4f}; B3 at "
          f"{tuple(q.shape)} held ({len(b3.calls)} launches, max|err| "
          f"{errs['dino_flash_attn']:.3g}): "
          f"{costs['dino_flash_attn']['ms']:.4f} ms, bound "
          f"{costs['dino_flash_attn']['bound_ms']:.4f}, SDPA "
          f"{costs['dino_flash_attn']['library_ms']:.4f} on {card}",
          flush=True)
    return {"launches": launches, "log_images_ms": log_ms,
            "image_tags": sorted({t for t, *_ in images}),
            "max_abs_err": errs,
            "costs": {k: {n: c.get(n) for n in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by",
                                                 "library_ms")}
                      for k, c in costs.items()}}


def check_panels(tag: str, vis_dir: str, frames: int, suffixes,
                 pairs: int = 0):
    """Every one of `frames` frames (named <video>_<frame>) has a file of
    each suffix in vis_dir, and `pairs` of them the CUB keypoint triple
    (_1, _2, _2_gt); nothing else is there. Returns the file count."""
    names = sorted(os.listdir(vis_dir))
    tags = sorted({n[:7] for n in names})
    kp = ("_1.png", "_2.png", "_2_gt.png")
    want = {t + x for t in tags for x in suffixes}
    triples = [t for t in tags if all(t + x in names for x in kp)]
    want |= {t + x for t in triples for x in kp}
    if len(tags) != frames or len(triples) != pairs or set(names) != want:
        fail(f"{tag}: panels {names}: expected {frames} frames with "
             f"{suffixes} and {pairs} keypoint triples")
    print(f"[{tag}] panels: {frames} frames x {len(suffixes)} files "
          f"{list(suffixes)}, {pairs} keypoint triples", flush=True)
    return len(names)


FRAME_PANELS = ("_img.png", "_bbox.png", "_match.png", "_imatch.png",
                "_gt.png", "_depth_gt.png", "_depth.png", "_tex.png",
                "_mask.png", "_conf.png", "_mesh.obj")
CROP_PANELS = ("_img.png", "_bbox.png", "_match.png", "_imatch.png",
               "_conf.png", "_depth.png", "_mask.png", "_mesh.obj")
VISUALIZE = [f"--visualize_{n}" for n in ("bbox", "match", "imatch", "conf",
                                          "mesh", "gt", "depth", "tex",
                                          "mask")]


def data_train(tag: str, flagfile: str, data_args, steps: int):
    """The training entry point on a fixture, launch counts zeroed just
    before and read just after: one render and 9 attention blocks a step,
    every logged loss finite. Returns (trainer, launches, the loader's
    wait in next() and the rest of the iteration, ms per step)."""
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.train import loop
    args = ["--flagfile", flagfile, *data_args, "--total_iters", str(steps),
            "--batch_log_interval", "1", "--checkpoint_dir", OUT, "--name",
            fresh_run(tag)]
    raster = ("raster_fused_fwd", "raster_fused_bwd")
    with contextlib.ExitStack() as stack:
        caps = {n: stack.enter_context(Capture(KR, f"{n}_cuda"))
                for n in raster}
        caps["dino_flash_attn"] = stack.enter_context(
            Capture(A, "flash_attention_cuda"))
        made = stack.enter_context(timed_loaders(loop, "TrainLoader"))
        reset_launches()
        t0 = time.time()
        trainer = loop.main(["train"] + args)
        torch.cuda.synchronize()
        launches = read_launches()
    drop_checkpoints()
    ld = made[0]
    timing = {"startup_s": ld.startup_s,
              "wait_ms": [w * 1e3 for w in ld.waits],
              "wall_ms": [w * 1e3 for w in ld.walls],
              "iter_ms": [(w + r) * 1e3 for w, r in zip(ld.waits, ld.walls)]}
    want = {n: steps if n in raster else 0 for n in launches}
    want["dino_flash_attn"] = ATTN_PER_STEP * steps
    print(f"[{tag}] loop.main {steps} steps on the fixture, wall "
          f"{time.time() - t0:.2f} s; kernel launches {launches}; loader "
          f"wait per step (ms) "
          f"{', '.join(f'{w:.2f}' for w in timing['wait_ms'])}",
          flush=True)
    if launches != want:
        fail(f"{tag}: launches {launches}, expected {want}")
    bad = [(st, k, v) for st, vals in trainer.logged for k, v in vals.items()
           if not math.isfinite(v)]
    if len(trainer.logged) != steps or bad:
        fail(f"{tag}: logged {len(trainer.logged)} of {steps} steps; "
             f"non-finite metrics: {bad}")
    print(f"[{tag}] logged total_loss: "
          + " ".join(f"{v['total_loss']:.8f}" for _, v in trainer.logged))
    for name, cap in caps.items():
        for args in cap.calls:      # its first launch (the counts are held)
            _, err, ok = hold(name, *args)
            if not ok:
                fail(f"{tag}: {name} disagrees with its plain version at "
                     f"this path's inputs ({err})")
    return trainer, launches, timing


def data_eval(tag: str, flagfile: str, data_args, extra, keys):
    """The predict entry point on a fixture, launch counts zeroed just
    before and read just after; every B1 launch held against the plain
    version; the metrics `keys` finite. Returns (results, launches)."""
    from selfcorr_tpu_torch import predict
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    args = ["--flagfile", flagfile, *data_args, "--eval", *extra,
            "--repeat", "1", "--dframe_eval", "1", "--checkpoint_dir", OUT,
            "--name", fresh_run(tag)]
    with Capture(KR, "raster_fused_fwd_cuda", every) as cap:
        reset_launches()
        t0 = time.time()
        results = predict.main(["predict"] + args)
        torch.cuda.synchronize()
        launches = read_launches()
    print(f"[{tag}] predict.main wall {time.time() - t0:.2f} s (cold); "
          f"kernel launches {launches}; "
          + " ".join(f"{k} {results.get(k)}" for k in keys), flush=True)
    if not all(k in results and math.isfinite(results[k]) for k in keys):
        fail(f"{tag}: metrics missing or not finite: {results}")
    for i, c in enumerate(cap.calls):
        _, err, ok = hold("raster_fused_fwd", *c)
        if not ok:
            fail(f"{tag}: B1 launch {i} disagrees with its plain version")
    return results, launches


def eval_rates(args, card: str) -> dict:
    """Wild6D evaluation over the 2 x RATE_FRAMES split (12 full batches of
    16): a warm Tester.test() (loading, predict, metrics), its set-up
    (dataset index, GT pkl, loader pool) apart from its loop, the loop's
    ms per batch waiting on the TestLoader and after it, and
    predict_batch alone, valid frames only in every rate; the native IoU's
    accumulate ms per sample beside the scipy IoU's."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.data.loader import TestLoader
    from selfcorr_tpu_torch.eval import metrics
    from selfcorr_tpu_torch.eval import tester as T
    from selfcorr_tpu_torch.eval.box3d import Box3D, box_iou
    cfg = parse_args(args).replace(train=False, vis_pred=False,
                                   device="cuda")
    tester = T.Tester(cfg)
    tester.test()                                    # warm
    torch.cuda.synchronize()
    with timed_loaders(T, "TestLoader") as made:
        t0 = time.perf_counter()
        res = tester.test()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    ld, frames = made[0], res["count"]
    if frames != 2 * RATE_FRAMES or len(ld.waits) != len(ld):
        fail(f"w6d_rates: {frames} frames in {len(ld.waits)} batches")
    setup_ms = (ld.built - t0) * 1e3
    loop_s = t1 - ld.built
    rates = {"frames": frames, "batches": len(ld.waits),
             "setup_ms": setup_ms, "e2e_fps": frames / (t1 - t0),
             "loop_fps": frames / loop_s,
             "load_ms_per_batch": statistics.median(ld.waits) * 1e3,
             "rest_ms_per_batch": statistics.median(ld.walls) * 1e3}
    loader = TestLoader(T.make_test_dataset(cfg), cfg)
    batch = next(iter(loader))
    loader.close()
    tester.predict_batch(batch)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        _, fit = tester.predict_batch(batch)
    torch.cuda.synchronize()
    rates["predict_batch_fps"] = (int(batch["valid"].sum()) * 10
                                  / (time.time() - t0))

    bbox9 = fit["bbox9"].cpu().numpy()
    gts = [(batch["rot_gt"][i], batch["trans_gt"][i], batch["scale_gt"][i])
           for i in np.flatnonzero(batch["valid"])]
    acc_ms = {}
    for sym in (cfg.symmetry_idx, 0):
        acc = metrics.NocsAccumulator(sym)
        t0 = time.perf_counter()
        for i, g in enumerate(gts):
            acc.add(bbox9[i], *g)
        acc_ms[f"native_sym{sym}"] = ((time.perf_counter() - t0) * 1e3
                                      / len(gts))
        t0 = time.perf_counter()
        for i, (rot, trans, scale) in enumerate(gts):
            box = Box3D(bbox9[i])
            n = 18 if sym == 0 else 1
            for k in range(n):
                box_iou(box, Box3D.from_transformation(
                    metrics._axis_angle_matrix(rot[:, 1], k * 2 * np.pi / n)
                    @ rot, trans, scale))
            metrics.deg_cm_error(sym, box, rot, trans, scale)
        acc_ms[f"scipy_sym{sym}"] = ((time.perf_counter() - t0) * 1e3
                                     / len(gts))
    print(f"[w6d_rates] warm Tester.test() over {frames} valid frames in "
          f"{rates['batches']} batches of {cfg.batch_size}: "
          f"{rates['e2e_fps']:.1f} frames/s with its set-up "
          f"({setup_ms:.2f} ms), {rates['loop_fps']:.1f} frames/s over its "
          f"loop, whose batches wait a median "
          f"{rates['load_ms_per_batch']:.2f} ms on the TestLoader and take "
          f"{rates['rest_ms_per_batch']:.2f} ms after it (predict, "
          f"metrics); predict_batch alone {rates['predict_batch_fps']:.1f} "
          f"frames/s on {card}", flush=True)
    print(f"[w6d_rates] NOCS accumulate ms per sample, native IoU beside "
          f"scipy's: " + ", ".join(f"{k} {v:.4f}" for k, v in acc_ms.items())
          + " (sym-1: one IoU, the laptop's; sym0: the 18-rotation sweep)",
          flush=True)
    return dict(rates, accumulate_ms=acc_ms)


def build_native() -> float:
    """Seconds to build the native box IoU with g++ from its source (any
    library built before is removed first) and bind it."""
    from selfcorr_tpu_torch.eval import box3d_native
    from selfcorr_tpu_torch.utils.cuda_build import library_path
    path = library_path(box3d_native.SOURCE, box3d_native.FLAGS)
    if os.path.exists(path):
        os.remove(path)
    box3d_native._lib = None
    t0 = time.time()
    box3d_native.build()
    build_s = time.time() - t0
    print(f"[data] native box IoU: g++ build and bind {build_s:.3f} s",
          flush=True)
    return build_s


def data_phase(card: str, synthetic_step_ms: float) -> dict:
    """Phase 12 (a)-(d) on fixtures written here (main removes them after
    phase 13, which reads the Wild6D test split too); their paths under
    "paths"."""
    out = {"probe": image_probe(), "native_build_s": build_native()}
    paths = write_fixtures()
    w6d = "config/wild6d/laptop.txt"
    # (a) Wild6D training, the compact path's width
    trainer, out["w6d_train_launches"], timing = data_train(
        "w6d_train", w6d, paths["w6d_train"], 3)
    out["loading"] = loading_costs(trainer)
    out["cpu"] = cpu_capacity()
    out["loader_wait_ms"] = timing["wait_ms"]
    out["step_ms_loading"] = step_beside_loaders(trainer, card)
    out["step_ms_fixture"] = out["step_ms_loading"]["alone"]
    out["step_ms_synthetic"] = synthetic_step_ms
    print(f"[w6d_train] loader wait per step "
          f"{', '.join(f'{w:.2f}' for w in timing['wait_ms'])} ms (the "
          f"first includes the first batch); warm train_step on the "
          f"fixture {out['step_ms_fixture']:.2f} ms, on synthetic data "
          f"{synthetic_step_ms} ms (phase 9) on {card}", flush=True)
    del trainer
    # 16 steps, past the batches queued ahead of the first, in each arm
    for tag, extra in (("w6d_train_long", ["--loader_processes"]),
                       ("w6d_train_long_threads", [])):
        _, out[f"{tag}_launches"], timing = data_train(
            tag, w6d, paths["w6d_train"] + extra, LONG_STEPS)
        out[tag] = timing
        steady = timing["wait_ms"][4:]
        print(f"[{tag}] loader start-up {timing['startup_s']:.3f} s; "
              f"wait per step, steps 5-{LONG_STEPS}: median "
              f"{statistics.median(steady):.2f} ms, max "
              f"{max(steady):.2f} ms; the loop's ms per iteration "
              f"(the wait and the rest) "
              f"{', '.join(f'{w:.1f}' for w in timing['iter_ms'])}, "
              f"median of steps 5-{LONG_STEPS} "
              f"{statistics.median(timing['iter_ms'][4:]):.2f} on "
              f"{card}", flush=True)
    # the trainer's image log
    out["w6d_vis"] = vis_train("w6d_vis", w6d, paths["w6d_train"], card)
    out["w6d_vis_launches"] = out["w6d_vis"]["launches"]
    # (b) Wild6D evaluation with every panel (3D figure: matplotlib)
    import importlib.util
    out["matplotlib"] = importlib.util.find_spec("matplotlib") is not None
    vis_dir = os.path.join(FIXTURES, "vis_w6d")
    out["w6d_eval"], out["w6d_eval_launches"] = data_eval(
        "w6d_eval", w6d, paths["w6d_test"] + ["--batch_size", "16"],
        ["--eval_nocs", "--vis_pred", *VISUALIZE, "--vis_path", vis_dir],
        NOCS_KEYS)
    if out["w6d_eval_launches"]["raster_fused_fwd"] != 2 * 12:
        fail("w6d_eval: the render panels did not launch B1 twice a "
             "frame")
    out["w6d_eval_panels"] = check_panels(
        "w6d_eval", vis_dir, 12,
        FRAME_PANELS + (("_3d.png",) if out["matplotlib"] else ()))
    out["w6d_eval_rates"] = eval_rates(
        ["--flagfile", w6d, *paths["w6d_rates"], "--batch_size", "16",
         "--eval", "--eval_nocs", "--repeat", "1", "--dframe_eval", "1",
         "--checkpoint_dir", OUT, "--name", fresh_run("w6d_rates")],
        card)
    # (c) NOCS
    nocs = "config/nocs/laptop.txt"
    _, out["nocs_train_launches"], _ = data_train("nocs_train", nocs,
                                                  paths["nocs"], 1)
    out["nocs_eval"], _ = data_eval("nocs_eval", nocs, paths["nocs"],
                                    ["--eval_nocs", "--batch_size",
                                     "16"], NOCS_KEYS)
    # (d) CUB
    cub = "config/cub/cub.txt"
    _, out["cub_train_launches"], _ = data_train("cub_train", cub,
                                                 paths["cub_train"], 1)
    vis_dir = os.path.join(FIXTURES, "vis_cub")
    out["cub_eval"], out["cub_eval_launches"] = data_eval(
        "cub_eval", cub, paths["cub_test"],
        ["--eval_cub", "--batch_size", "8", "--vis_pred", "--vis_path",
         vis_dir], ("mIoU", "kp@0.1", "kp@0.2"))
    if out["cub_eval_launches"]["raster_fused_fwd"] != 1:
        fail(f"cub_eval: B1 launched "
             f"{out['cub_eval_launches']['raster_fused_fwd']} times for "
             f"one eval batch")
    out["cub_eval_panels"] = check_panels("cub_eval", vis_dir, 8,
                                          CROP_PANELS, pairs=4)
    out["paths"] = paths
    return out


# ---------------------------------------------------------------------------
# phase 13: data parallel
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_WORK = os.path.join(ROOT, ".work", "dp")   # rank files, removed after


def dp_want(steps: int) -> dict:
    return {"raster_fused_fwd": steps, "raster_fused_bwd": steps,
            "raster_fused_fwd_chunk": 0, "raster_fused_bwd_chunk": 0,
            "dino_flash_attn": ATTN_PER_STEP * steps}


def dp_world_one(card: str) -> dict:
    """(i) The train entry point with --num_processes 1 --process_id 0
    --coordinator_address: 3 steps through an NCCL group of one (every
    all_mean_ of the run seen in it); then, in a new group of one, one step
    through it against one without it from one state, batch and draws (bit
    for bit where two runs of that step from one state are), the warm
    step with and without it in turns, all_mean_ alone, and the peak
    device memory of a step."""
    import torch.distributed as dist
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch.train import loop
    from selfcorr_tpu_torch.train import step as ST
    steps = 3
    args = TRAIN_ARGS + ["--total_iters", str(steps), "--num_processes", "1",
                         "--process_id", "0", "--coordinator_address",
                         f"127.0.0.1:{P.free_port()}", "--checkpoint_dir",
                         OUT, "--name", fresh_run("dp_world1")]
    seen = []
    real = ST.all_mean_

    def spy(tensors, group=None):
        seen.append((dist.get_backend(group), dist.get_world_size(group)))
        return real(tensors, group)
    ST.all_mean_ = spy
    try:
        reset_launches()
        t0 = time.time()
        trainer = loop.main(["train"] + args)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        ST.all_mean_ = real
    drop_checkpoints()
    print(f"[dp_world1] loop.main {steps} steps through an NCCL group of "
          f"one, wall {time.time() - t0:.2f} s; kernel launches {launches}; "
          f"all_mean_ ran in {seen}", flush=True)
    if launches != dp_want(steps):
        fail(f"dp_world1: launches {launches}, expected {dp_want(steps)}")
    if seen != [("nccl", 1)] * steps or dist.is_initialized():
        fail(f"dp_world1: all_mean_ ran in {seen} (expected an NCCL group "
             f"of one each step), group left initialised: "
             f"{dist.is_initialized()}")
    bad = [(st, k, v) for st, vals in trainer.logged for k, v in vals.items()
           if not math.isfinite(v)]
    if len(trainer.logged) != steps or bad:
        fail(f"dp_world1: logged {len(trainer.logged)} of {steps} steps; "
             f"non-finite metrics: {bad}")

    cfg, state = trainer.cfg, trainer.state
    batch, draws = train_batch(trainer)
    P.init_distributed(0, 1, f"127.0.0.1:{P.free_port()}", "cuda")
    try:
        group = dist.group.WORLD
        with deterministic():
            noise = max_diff(stepped(state, batch, draws, cfg),
                             stepped(state, batch, draws, cfg))
            err = max_diff(stepped(state, batch, draws, cfg, group),
                           stepped(state, batch, draws, cfg))
        print(f"[dp_world1] one step through the group vs without it, one "
              f"state, batch and draws: max|diff| {err:.3g} over every "
              f"parameter, buffer, moment and metric (two runs without it: "
              f"{noise:.3g}; deterministic algorithms)", flush=True)
        if not (err == 0.0 if noise == 0.0 else err <= noise):
            fail(f"dp_world1: the step through the group is {err:.3g} from "
                 f"the step without it, beyond the step's noise {noise:.3g}")
        times = {"group": [], "none": []}
        for i in range(10):      # in turns: none, group, group, none, ...
            which = "group" if i % 4 in (1, 2) else "none"
            torch.cuda.synchronize()
            t0 = time.time()
            ST.train_step(state, batch, draws, cfg,
                          group if which == "group" else None)
            torch.cuda.synchronize()
            times[which].append((time.time() - t0) * 1e3)
        grads = [p.grad.clone() for p in state.model.parameters()]
        stats = [b.clone() for b in ST.running_stats(state.model)]
        mean_ms = time_ms(lambda: P.all_mean_(grads + stats, group), reps=10)
        torch.cuda.reset_peak_memory_stats()
        ST.train_step(state, batch, draws, cfg, group)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    n_floats = sum(t.numel() for t in grads + stats)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[dp_world1] warm train_step at batch 32: through the NCCL group "
          f"of one median {med['group']:.2f} ms "
          f"({', '.join(f'{t:.1f}' for t in times['group'])}), without it "
          f"{med['none']:.2f} ms "
          f"({', '.join(f'{t:.1f}' for t in times['none'])}); all_mean_ "
          f"alone over {n_floats} floats (gradients and BatchNorm "
          f"statistics, {4 * n_floats} bytes) {mean_ms:.3f} ms; peak device "
          f"memory of a step {peak} bytes on {card}", flush=True)
    return {"launches": launches, "parity_max_diff": err,
            "step_noise": noise, "step_ms_group": med["group"],
            "step_ms_none": med["none"], "step_ms_all": times,
            "all_mean_ms": mean_ms, "all_mean_floats": n_floats,
            "peak_bytes": peak}


def dp_step_rank(rank, work: str):
    """(ii), in each of the ranks on cuda:0 over gloo: a Trainer of the
    rank (batch 4 x 4: its 16 rows of the 32 that the two-shard plan of
    step 0 draws, its own draws); under the deterministic algorithms, two
    single-rank steps on those rows (their difference: the step's noise;
    the first's gradients before the clip, BatchNorm statistics and aux
    losses to work/single<r>.pt), then the two-rank step, its launches
    counted and its first B1, B2 and B3 inputs held against the plain
    versions (its state to work/dp<r>.pt); warm two-rank steps timed; peak
    device memory. Rank 0 then holds its state against the composite of
    the single-rank steps (their mean, the clip and one AdamW step from the
    initial state) and against rank 1's."""
    global torch
    import torch
    import torch.distributed as dist
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.data.loader import (compress_batch_host,
                                                stack_items)
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.train import loop
    from selfcorr_tpu_torch.train import step as ST
    r = rank.rank
    cfg = parse_args(TRAIN_ARGS + [
        "--batch_size", "4", "--repeat", "4", "--num_devices",
        str(DP_RANKS), "--checkpoint_dir", os.path.join(work, "run")])
    trainer = loop.Trainer(cfg, rank)
    ds = loop.make_train_dataset(cfg, DP_RANKS)
    plan = ds.sample_plan(0)
    lo, hi = P.process_row_range(r, DP_RANKS, len(plan))
    batch = trainer.upload(compress_batch_host(stack_items(
        [ds.load_item(*a) for a in plan[lo:hi]])))
    draws = draw_step(loop.step_generator(cfg.seed, 0, r), cfg, hi - lo)
    state = trainer.state
    init = copy.deepcopy(state)
    with deterministic():
        noise = max_diff(stepped(state, batch, draws, cfg),
                         stepped(state, batch, draws, cfg))
        st = copy.deepcopy(state)
        grads = {}
        guard = ST.clip_and_guard

        def keep_then_clip(model):
            grads.update({n: p.grad.clone()
                          for n, p in model.named_parameters()})
            return guard(model)
        ST.clip_and_guard = keep_then_clip
        try:
            m = ST.train_step(st, batch, draws, cfg)
        finally:
            ST.clip_and_guard = guard
        torch.save({"grads": grads, "metrics": m,
                    "stats": {n: b for n, b in st.model.named_buffers()}},
                   os.path.join(work, f"single{r}.pt"))
        del st
        st = copy.deepcopy(state)
        with contextlib.ExitStack() as stack:
            caps = {n: stack.enter_context(Capture(KR, f"{n}_cuda"))
                    for n in ("raster_fused_fwd", "raster_fused_bwd")}
            caps["dino_flash_attn"] = stack.enter_context(
                Capture(A, "flash_attention_cuda"))
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            m = ST.train_step(st, batch, draws, cfg, rank.group)
            torch.cuda.synchronize()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
    dp = {**state_tensors(st),
          **{f"metric.{k}": v.reshape(1) for k, v in m.items()}}
    torch.save(dp, os.path.join(work, f"dp{r}.pt"))
    errs = {}
    for name, cap in caps.items():
        _, err, ok = hold(name, *cap.calls[0])
        errs[name] = err if isinstance(err, float) else max(err.values())
        if not ok:
            raise RuntimeError(f"rank {r}: {name} disagrees with its plain "
                               f"version at the two-rank step's inputs "
                               f"({err})")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ST.train_step(st, batch, draws, cfg, rank.group)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    out = {"rank": r, "rows": [lo, hi], "launches": launches,
           "peak_bytes": peak, "step_ms": times, "max_abs_err": errs,
           "step_noise": noise, "metrics": {k: float(v)
                                            for k, v in m.items()}}
    dist.barrier()
    if r == 0:
        single = [torch.load(os.path.join(work, f"single{i}.pt"),
                             map_location="cuda:0")
                  for i in range(DP_RANKS)]
        st = init
        model = st.model
        with torch.no_grad():
            for n, b in model.named_buffers():
                if n.endswith(("running_mean", "running_var")):
                    b.copy_(sum(s["stats"][n] for s in single) / DP_RANKS)
                else:
                    b.copy_(single[0]["stats"][n])
        for n, p in model.named_parameters():
            p.grad = sum(s["grads"][n] for s in single) / DP_RANKS
        ST.clip_and_guard(model)
        st.optimizer.step(st.step)
        st.step += 1
        comp = state_tensors(st)
        metrics = {k: sum(s["metrics"][k] for s in single) / DP_RANKS
                   for k in single[0]["metrics"]
                   if not k.startswith("grad_") and k != "bad_grad"}
        other = torch.load(os.path.join(work, "dp1.pt"),
                           map_location="cuda:0")
        out["composite_max_diff"] = max_diff(
            {k: dp[k] for k in comp}, comp)
        out["aux_vs_composite_max_diff"] = max(
            abs(float(dp[f"metric.{k}"]) - float(v))
            for k, v in metrics.items())
        out["ranks_max_diff"] = max_diff(dp, other)
    with open(os.path.join(work, f"rank{r}.json"), "w") as f:
        json.dump(out, f)


def dp_two_ranks_on_one_card(card: str) -> dict:
    """(ii) Two ranks on cuda:0 over gloo (NCCL takes one rank a GPU)."""
    from selfcorr_tpu_torch import parallel as P
    shutil.rmtree(DP_WORK, ignore_errors=True)
    os.makedirs(DP_WORK)
    torch.cuda.empty_cache()
    t0 = time.time()
    P.run_ranks(dp_step_rank, P.Layout(DP_RANKS, 0, ("cuda:0",) * DP_RANKS,
                                       backend="gloo"), DP_WORK)
    wall = time.time() - t0
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(DP_WORK, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(DP_WORK, ignore_errors=True)
    r0 = ranks[0]
    for rk in ranks:
        print(f"[dp_gloo] rank {rk['rank']} (rows {rk['rows']}, batch 4 x 4 "
              f"of the global 32): kernel launches {rk['launches']}; max"
              f"|kernel - plain| at its step's inputs {rk['max_abs_err']}; "
              f"peak device memory of its step {rk['peak_bytes']} bytes; "
              f"warm two-rank step (gloo, both ranks on one card, not a "
              f"data-parallel rate) "
              f"{', '.join(f'{t:.1f}' for t in rk['step_ms'])} ms on "
              f"{card}", flush=True)
    print(f"[dp_gloo] two-rank step vs the composite of the single-rank "
          f"steps (mean, clip, AdamW): max|diff| "
          f"{r0['composite_max_diff']:.3g} over every parameter, buffer "
          f"and moment, aux losses {r0['aux_vs_composite_max_diff']:.3g}; "
          f"rank 1 vs rank 0 {r0['ranks_max_diff']:.3g}; a single-rank "
          f"step's own noise {[rk['step_noise'] for rk in ranks]} "
          f"(deterministic algorithms); {wall:.1f} s with the ranks' "
          f"start", flush=True)
    noise = max(rk["step_noise"] for rk in ranks)
    bad = [rk["rank"] for rk in ranks if rk["launches"] != dp_want(1)]
    if bad:
        fail(f"dp_gloo: ranks {bad} launched {[ranks[i]['launches'] for i in bad]}, "
             f"expected {dp_want(1)} each")
    for key in ("composite_max_diff", "aux_vs_composite_max_diff"):
        if not (r0[key] == 0.0 if noise == 0.0 else r0[key] <= noise):
            fail(f"dp_gloo: {key} {r0[key]:.3g}, beyond the step's noise "
                 f"{noise:.3g}")
    if r0["ranks_max_diff"] != 0.0:
        fail(f"dp_gloo: the ranks' states differ after the step by "
             f"{r0['ranks_max_diff']:.3g}")
    return {"ranks": ranks, "wall_s": wall}


def dp_eval_rank(rank, args, out: str):
    """(iii), in each rank: the Tester over the ranks' split of each
    batch; its metrics and launches to `out`<r>.json."""
    global torch
    import torch
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.eval.tester import Tester
    from selfcorr_tpu_torch.utils.device import set_fp32_precision
    set_fp32_precision()
    cfg = parse_args(args).replace(train=False)
    with deterministic():
        reset_launches()
        results = Tester(cfg, rank=rank).test()
        launches = read_launches()
    with open(f"{out}{rank.rank}.json", "w") as f:
        json.dump({"results": results, "launches": launches}, f)


def dp_eval(paths, phase12: dict) -> dict:
    """(iii) The Wild6D fixture's test split (2 x 6 frames, one batch of
    16, its tail padded) on two ranks on cuda:0 over gloo, 8 rows each,
    against one rank: the six NOCS metrics equal."""
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch import predict
    args = ["--flagfile", "config/wild6d/laptop.txt", *paths["w6d_test"],
            "--eval", "--eval_nocs", "--batch_size", "16", "--repeat", "1",
            "--dframe_eval", "1", "--checkpoint_dir", OUT, "--name",
            fresh_run("dp_eval")]
    with deterministic():
        one = predict.main(["predict"] + args)
    os.makedirs(DP_WORK, exist_ok=True)
    out = os.path.join(DP_WORK, "eval")
    torch.cuda.empty_cache()
    P.run_ranks(dp_eval_rank, P.Layout(DP_RANKS, 0, ("cuda:0",) * DP_RANKS,
                                       backend="gloo"),
                args + ["--num_devices", str(DP_RANKS)], out)
    ranks = []
    for r in range(DP_RANKS):
        with open(f"{out}{r}.json") as f:
            ranks.append(json.load(f))
    shutil.rmtree(DP_WORK, ignore_errors=True)
    two = {k: ranks[0]["results"][k] for k in NOCS_KEYS}
    print(f"[dp_eval] Wild6D fixture, 12 frames in one batch of 16: one "
          f"rank {' '.join(f'{k} {one[k]}' for k in NOCS_KEYS)}; two ranks "
          f"(8 rows each, gloo on one card) "
          f"{' '.join(f'{k} {two[k]}' for k in NOCS_KEYS)}; phase 12's "
          f"run with the panels "
          f"{' '.join(f'{k} {phase12[k]}' for k in NOCS_KEYS)}; launches "
          f"per rank {[rk['launches'] for rk in ranks]}", flush=True)
    if any(rk["results"] != ranks[0]["results"] for rk in ranks):
        fail("dp_eval: the ranks returned different metrics")
    if two != {k: one[k] for k in NOCS_KEYS}:
        fail(f"dp_eval: two ranks {two}, one rank "
             f"{ {k: one[k] for k in NOCS_KEYS} }")
    return {"one_rank": one, "two_ranks": ranks[0]["results"],
            "launches": [rk["launches"] for rk in ranks]}


def dp_phase(card: str, paths, phase12_eval: dict) -> dict:
    """Phase 13 (i)-(iii)."""
    out = {"world1": dp_world_one(card)}
    out["gloo"] = dp_two_ranks_on_one_card(card)
    out["eval"] = dp_eval(paths, phase12_eval)
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


# phase 14: the last trainer flags
FLAGS_WORK = os.path.join(ROOT, ".work", "flags")  # profiler run, removed
DEVSYNTH_ARGS = ["--synthetic_on_device", "--batch_log_interval", "2",
                 "--total_iters", "6"]


class AttnHold:
    """Wraps B3's wrapper while a run goes: each launch's inputs are held
    against the plain version right there, on the views the path passes
    (their dtype and strides kept); the count stays the wrapper's."""

    def __init__(self):
        from selfcorr_tpu_torch.ops import attention as A
        self.module, self.fn = A, A.flash_attention_cuda
        self.errs, self.bad, self.layouts = [], 0, set()

    def __enter__(self):
        def spy(q, k, v):
            out = self.fn(q, k, v)
            _, err, ok = (None, *attn_compare(
                out, self.module.flash_attention_plain(q, k, v), v))
            self.errs.append(err)
            self.bad += not ok
            self.layouts.add((str(q.dtype), tuple(q.shape), q.stride()))
            return out
        self.module.flash_attention_cuda = spy
        return self

    def __exit__(self, *exc):
        self.module.flash_attention_cuda = self.fn


def run_launches(argv, want: dict, tag: str, attn: AttnHold | None = None):
    """The train entry point with `argv`, launch counts zeroed just before
    and read just after; fails unless they are `want` and every logged
    loss is finite. Returns (trainer, launches)."""
    from selfcorr_tpu_torch.train import loop
    with (attn or contextlib.nullcontext()):
        reset_launches()
        trainer = loop.main(["train"] + argv)
        torch.cuda.synchronize()
        launches = read_launches()
    if launches != want:
        fail(f"{tag}: launches {launches}, expected {want}")
    bad = [(st, k) for st, vals in trainer.logged for k, v in vals.items()
           if not math.isfinite(v)]
    if not trainer.logged or bad:
        fail(f"{tag}: {len(trainer.logged)} logs, non-finite {bad}")
    print(f"[{tag}] launches {launches}; logged total_loss "
          + " ".join(f"{st}:{v['total_loss']:.8f}"
                     for st, v in trainer.logged), flush=True)
    return trainer, launches


def bf16_trunk_card_vs_cpu() -> dict:
    """The bf16 trunk at the path's width (img 256) on the card against the
    same trunk on the CPU, two images."""
    from selfcorr_tpu_torch.models.vit import DinoViTS8
    torch.manual_seed(0)
    cpu = DinoViTS8(img_size=256).to(torch.bfloat16).eval()
    card = copy.deepcopy(cpu).to("cuda")
    img = torch.rand((2, 256, 256, 3), generator=torch.Generator()
                     .manual_seed(1)).bfloat16()
    with torch.no_grad():
        got = card(img.cuda()).float().cpu()
        t0 = time.time()
        want = cpu(img).float()
        cpu_s = time.time() - t0
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    mean = float((got - want).abs().mean()) / scale
    print(f"[bf16] trunk features card vs CPU at (2, 256, 256): max|diff| "
          f"{err:.3g}, mean {mean:.3g} of their largest entry (bounds 2e-2, "
          f"3e-3); the CPU trunk took {cpu_s:.1f} s", flush=True)
    if not (err <= 2e-2 and mean <= 3e-3):
        fail(f"the bf16 trunk on the card is {err:.3g} (mean {mean:.3g}) "
             f"from the CPU's")
    return {"max_rel": err, "mean_rel": mean}


def step_ab_in_turns(a, b, batch, draws, turns: int = 4, reps: int = 3):
    """Warm train_step of Trainers a and b on one batch, in turns (a b b a
    ...): median ms of each over `turns` x `reps` synchronized steps."""
    from selfcorr_tpu_torch.train.step import train_step
    ms = {0: [], 1: []}
    order = [0, 1, 1, 0] * (turns // 2)
    for i in order:
        t = (a, b)[i]
        train_step(t.state, batch, draws, t.cfg)
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.time()
            train_step(t.state, batch, draws, t.cfg)
            torch.cuda.synchronize()
            ms[i].append((time.time() - t0) * 1e3)
    return statistics.median(ms[0]), statistics.median(ms[1]), ms


def bf16_phase(card: str) -> dict:
    """(a) --dino_bf16: 3 steps through the entry point, every B3 launch
    held against the plain version at its bf16-qkv views; the trunk on the
    card against the CPU; the warm step with and without the flag in
    turns; one _log_images; save and resume bit for bit."""
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.train import loop
    want = dp_want(3)
    with AttnHold() as attn:
        trainer, launches = run_launches(
            TRAIN_ARGS + ["--dino_bf16", "--total_iters", "3",
                          "--checkpoint_dir", OUT, "--name",
                          fresh_run("bf16")], want, "bf16", attn)
    if trainer.state.dino.dtype != torch.bfloat16:
        fail(f"--dino_bf16: the trunk is {trainer.state.dino.dtype}")
    print(f"[bf16] {len(attn.errs)} B3 launches held against the plain "
          f"version at the bf16 trunk's views {sorted(attn.layouts)}: max|"
          f"err| {max(attn.errs):.3g}, {attn.bad} beyond the bound",
          flush=True)
    if attn.bad or len(attn.errs) != want["dino_flash_attn"]:
        fail(f"B3 at the bf16 trunk's inputs: {attn.bad} of "
             f"{len(attn.errs)} launches disagree")
    trunk = bf16_trunk_card_vs_cpu()

    # save (the run's final checkpoint, step 3) and resume bit for bit
    resumed = loop.Trainer(trainer.cfg)
    saved, got = state_tensors(trainer.state), state_tensors(resumed.state)
    bad = [k for k in saved if got[k].dtype != saved[k].dtype
           or not torch.equal(got[k], saved[k])]
    if resumed.state.step != 3 or bad:
        fail(f"--dino_bf16 resume: step {resumed.state.step}, differ "
             f"{bad[:10]}")
    cfg = trainer.cfg
    batch, _ = train_batch(trainer)
    draws = draw_step(loop.step_generator(cfg.seed, 3), cfg,
                      batch["img"].shape[0])
    with deterministic():
        noise = max_diff(stepped(trainer.state, batch, draws, cfg),
                         stepped(trainer.state, batch, draws, cfg))
        err = max_diff(stepped(resumed.state, batch, draws, cfg),
                       stepped(trainer.state, batch, draws, cfg))
    print(f"[bf16] resumed at step 3 with a bf16 trunk equal to the saved "
          f"one ({len(saved)} tensors); its next step vs the straight "
          f"run's: max|diff| {err:.3g} (two runs of the step: {noise:.3g})",
          flush=True)
    if not (err == 0.0 if noise == 0.0 else err <= noise):
        fail(f"--dino_bf16: the resumed step is {err:.3g} off (noise "
             f"{noise:.3g})")
    del resumed

    # one _log_images: B1 twice at B = 2, B3 9 times in an f32 copy of the
    # bf16 trunk
    writer = ImageLog(loop.NoopWriter())
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    trainer._log_images(writer, batch, 3)
    torch.cuda.synchronize()
    log_ms = (time.time() - t0) * 1e3
    vis_launches = read_launches()
    vis_want = {"raster_fused_fwd": 2, "raster_fused_bwd": 0,
                "raster_fused_fwd_chunk": 0, "raster_fused_bwd_chunk": 0,
                "dino_flash_attn": ATTN_PER_STEP}
    if vis_launches != vis_want or len(writer.images) != 20:
        fail(f"--dino_bf16 _log_images: launches {vis_launches}, "
             f"{len(writer.images)} images")
    print(f"[bf16] _log_images with the bf16 trunk: {len(writer.images)} "
          f"images, launches {vis_launches}, {log_ms:.1f} ms on {card}",
          flush=True)

    # the warm step with and without the flag, in turns (recorded)
    plain = loop.Trainer(cfg.replace(dino_bf16=False, name=fresh_run(
        "bf16_off")))
    f32_ms, bf16_ms, all_ms = step_ab_in_turns(plain, trainer, batch, draws)
    print(f"[bf16] warm train_step at batch 32 in turns: f32 trunk "
          f"{f32_ms:.2f} ms, bf16 trunk {bf16_ms:.2f} ms (medians of "
          f"{len(all_ms[0])} each) on {card}", flush=True)
    del plain, trainer
    drop_checkpoints()
    return {"launches": launches, "vis_launches": vis_launches,
            "b3_max_abs_err": max(attn.errs), "b3_layouts": sorted(
                map(str, attn.layouts)), "trunk_card_vs_cpu": trunk,
            "resume_max_diff": err, "step_noise": noise,
            "log_images_ms": log_ms, "step_ms_f32_trunk": f32_ms,
            "step_ms_bf16_trunk": bf16_ms, "step_ms_all": all_ms}


def silhouette(mask):
    """Pixels of a (B, H, W) bool mask with a pixel of the other value in
    their 3 x 3 neighbourhood."""
    m = mask.float()[:, None]
    pad = torch.nn.functional.pad(m, (1, 1, 1, 1), mode="replicate")
    lo = -torch.nn.functional.max_pool2d(-pad, 3, 1)
    hi = torch.nn.functional.max_pool2d(pad, 3, 1)
    return (lo != hi)[:, 0]


def devsynth_card_vs_cpu(cfg) -> dict:
    """The device generator's batch at the path's width on the card
    against the CPU's, given one set of draws: boxes exact, masks equal
    off the silhouette, img and depth where the masks agree."""
    from selfcorr_tpu_torch.data import synthetic_device as SD
    from selfcorr_tpu_torch.data.synthetic import SyntheticVideos
    videos = SyntheticVideos(seed=cfg.seed, shape=cfg.synthetic_shape)
    bs, rp = cfg.batch_size, cfg.repeat
    g = torch.Generator().manual_seed(14)
    vids = torch.randint(0, videos.n_videos, (bs,), generator=g)
    offs = torch.randint(0, videos.n_frames // rp, (bs, rp), generator=g)
    scale = 1.2 + 0.3 * torch.rand((bs * rp, 2), generator=g)
    boxes = []
    for dev in ("cpu", "cuda"):
        t = SD.video_tables(videos, dev)
        v = torch.repeat_interleave(vids, rp).to(dev)
        fids = torch.clamp(torch.arange(rp)[None] * (videos.n_frames // rp)
                           + offs, max=videos.n_frames - 1).reshape(-1)
        theta = t["phase"][v] + 2.0 * math.pi * fids.float().to(dev) \
            / videos.n_frames
        rot = SD.rot_mats(t["tilt"][v], theta)
        boxes.append([x.cpu() for x in SD.crop_bbox_analytic(
            t, v, rot, t["z0"][v], videos.raw, 1 if videos.shape ==
            "ellipsoid" else 2)])
    box_diff = sum(int((a != b).any(-1).sum()) for a, b in zip(*boxes))
    cpu_gen = SD.make_device_synth(cfg, videos, "cpu")
    card_gen = SD.make_device_synth(cfg, videos, "cuda")
    want = cpu_gen(vids=vids, offs=offs, scale=scale)
    got = {k: v.cpu() for k, v in card_gen(vids=vids, offs=offs,
                                           scale=scale).items()}
    flips = got["mask"] != want["mask"]
    off_edge = int((flips & ~silhouette(want["mask"] > 0)).sum())
    same = ~flips
    img_err = float((got["img"] - want["img"]).abs()[same].max())
    depth_err = float((got["depth"] - want["depth"]).abs()[same].max())
    intr = max(float((got[k] - want[k]).abs().max())
               for k in ("foc_crop", "pp_crop"))
    print(f"[devsynth] generator card vs CPU at batch {bs * rp} x "
          f"{cfg.img_size}^2 on one set of draws: crop boxes differing "
          f"{box_diff}; mask pixels differing {int(flips.sum())} of "
          f"{flips.numel()} ({off_edge} off the silhouette); where the masks "
          f"agree img max|diff| {img_err:.3g} (bound 5e-3), depth "
          f"{depth_err:.3g} mm (bound 2); foc/pp {intr:.3g}", flush=True)
    if (box_diff or off_edge or float(flips.float().mean()) > 1e-3
            or img_err > 5e-3 or depth_err > 2.0 or intr > 1e-5):
        fail("the device generator on the card disagrees with the CPU's")
    # ms per batch on the card, the draws made once
    gen_ms = time_ms(lambda: card_gen(vids=vids, offs=offs, scale=scale),
                     reps=10)
    return {"box_diff": box_diff, "mask_flips": int(flips.sum()),
            "mask_flips_off_silhouette": off_edge, "img_max_abs": img_err,
            "depth_max_abs_mm": depth_err, "gen_ms": gen_ms}


def devsynth_phase(card: str, phase9_step_ms: float) -> dict:
    """(b) --dataset_name synthetic --synthetic_on_device: the generator on
    the card against the CPU's; --steps_per_dispatch 1 and 3 over 6 steps
    at --batch_log_interval 2, equal where two runs of K = 1 are (phase
    10's rule), under the deterministic algorithms; the generator's ms per
    batch beside train_step, and the step with device batches."""
    from selfcorr_tpu_torch.data import synthetic_device as SD
    from selfcorr_tpu_torch.train.step import train_step
    from selfcorr_tpu_torch.models.meshnet import draw_step
    from selfcorr_tpu_torch.train import loop
    runs, launches = {}, {}
    with deterministic():
        for tag, k in (("devsynth_k1", 1), ("devsynth_k1b", 1),
                       ("devsynth_k3", 3)):
            runs[tag], launches[tag] = run_launches(
                TRAIN_ARGS + DEVSYNTH_ARGS + [
                    "--steps_per_dispatch", str(k), "--checkpoint_dir",
                    OUT, "--name", fresh_run(tag)], dp_want(6), tag)
    drop_checkpoints()
    if runs["devsynth_k3"].chunks != [2, 2, 2] or \
            runs["devsynth_k1"].chunks != [1] * 6:
        fail(f"chunks: K=1 {runs['devsynth_k1'].chunks}, K=3 "
             f"{runs['devsynth_k3'].chunks}")
    a, b, c = (state_tensors(runs[t].state) for t in (
        "devsynth_k1", "devsynth_k1b", "devsynth_k3"))
    noise, err = max_diff(a, b), max_diff(a, c)
    logs = [[(st, v) for st, v in runs[t].logged]
            for t in ("devsynth_k1", "devsynth_k1b", "devsynth_k3")]
    log_noise = max(abs(x[1][n] - y[1][n]) for x, y in zip(logs[0], logs[1])
                    for n in x[1])
    log_err = max(abs(x[1][n] - y[1][n]) for x, y in zip(logs[0], logs[2])
                  for n in x[1])
    steps_logged = [[st for st, _ in lg] for lg in logs]
    print(f"[devsynth] K=3 vs K=1 after 6 steps: model and optimizer "
          f"max|diff| {err:.3g}, logged losses {log_err:.3g} at steps "
          f"{steps_logged[2]}; two K=1 runs: {noise:.3g}, {log_noise:.3g}",
          flush=True)
    if steps_logged[0] != steps_logged[2] or not (
            (err == 0.0 and log_err == 0.0) if noise == 0.0 == log_noise
            else (err <= noise and log_err <= log_noise)):
        fail("--steps_per_dispatch 3 differs from 1 beyond two runs of 1")

    trainer = runs["devsynth_k1"]
    cfg = trainer.cfg
    gen_cmp = devsynth_card_vs_cpu(cfg)
    gen = SD.make_device_synth(cfg, loop.make_train_dataset(cfg).videos,
                               trainer.device)
    batch = gen(SD.step_generator(cfg.seed, 0))
    draws = draw_step(loop.step_generator(cfg.seed, 0), cfg,
                      batch["img"].shape[0])
    step_ms = time_ms(lambda: train_step(trainer.state, batch, draws, cfg),
                      reps=5, warmup=1, trials=1)
    both_ms = time_ms(lambda: train_step(trainer.state, gen(
        SD.step_generator(cfg.seed, 0)), draws, cfg), reps=5, warmup=1,
        trials=1)
    print(f"[devsynth] at batch 32 on {card}: the generator "
          f"{gen_cmp['gen_ms']:.3f} ms a batch, train_step "
          f"{step_ms:.2f} ms, generator + train_step {both_ms:.2f} ms a "
          f"step (phase 9's warm step on host-loader batches "
          f"{phase9_step_ms:.2f} ms)", flush=True)
    del runs, trainer
    return {"launches": {t: launches[t] for t in ("devsynth_k1",
                                                  "devsynth_k3")},
            "k3_vs_k1_max_diff": err, "k3_vs_k1_log_diff": log_err,
            "k1_noise": noise, "k1_log_noise": log_noise,
            "generator": gen_cmp, "step_ms": step_ms,
            "gen_and_step_ms": both_ms}


def profile_phase() -> dict:
    """(c) --profile_steps 2 over 13 steps: rank 0 writes a non-empty
    Chrome trace of steps 11 and 12 under <run>/trace."""
    shutil.rmtree(FLAGS_WORK, ignore_errors=True)
    trainer, launches = run_launches(
        TRAIN_ARGS + ["--profile_steps", "2", "--total_iters", "13",
                      "--checkpoint_dir", FLAGS_WORK, "--name", "profile"],
        dp_want(13), "profile")
    trace = os.path.join(trainer.run_dir, "trace")
    files = sorted(os.listdir(trace)) if os.path.isdir(trace) else []
    sizes = [os.path.getsize(os.path.join(trace, f)) for f in files]
    events = []
    if files:
        with open(os.path.join(trace, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[profile] trace files {files} ({sizes} bytes, {len(events)} "
          f"events, {kernels} of them device kernels)", flush=True)
    if files != ["steps_11-12.json"] or not events:
        fail(f"--profile_steps 2: trace directory holds {files}")
    shutil.rmtree(FLAGS_WORK, ignore_errors=True)
    return {"launches": launches, "files": files, "bytes": sizes,
            "events": len(events), "kernel_events": kernels}


def flags_phase(card: str, phase9_step_ms: float) -> dict:
    """Phase 14."""
    out = {"bf16": bf16_phase(card)}
    out["devsynth"] = devsynth_phase(card, phase9_step_ms)
    out["profile"] = profile_phase()
    return out


def device_setup():
    """Require CUDA; print the card's name and power limit and the torch
    build; work from the repo's root with float32 precision. Returns
    (the nvidia-smi line, the device name, the device)."""
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    os.makedirs(OUT, exist_ok=True)
    from selfcorr_tpu_torch.utils.device import set_fp32_precision
    set_fp32_precision()
    return smi, kind, torch.device("cuda:0")


def main() -> int:
    t_start = time.time()
    smi, kind, dev = device_setup()
    from selfcorr_tpu_torch.ops import attention as A
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.utils import cuda_build

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

    phase("checkpoint, resume and imports")
    ckpt_res = checkpoint_phase(smi)

    phase("report")
    # B1' and B2' with texels at the surface path's inputs too
    captured["train_surface"] = with_chunks(captured["train_surface"])
    main_costs = {p: report_main_path(p, c) for p, c in captured.items()}

    try:
        phase("data: Wild6D, NOCS and CUB fixtures")
        data = data_phase(smi, steps["train"][0])
        phase("data parallel")
        dp = dp_phase(smi, data.pop("paths"), data["w6d_eval"])
        phase("the last trainer flags: --dino_bf16, --synthetic_on_device, "
              "--profile_steps")
        flags = flags_phase(smi, steps["train"][0])
    finally:
        shutil.rmtree(FIXTURES, ignore_errors=True)
        shutil.rmtree(DP_WORK, ignore_errors=True)
        shutil.rmtree(FLAGS_WORK, ignore_errors=True)
        drop_checkpoints()
    launches.update({p: data[f"{p}_launches"] for p in (
        "w6d_train", "w6d_train_long", "w6d_train_long_threads", "w6d_vis",
        "w6d_eval", "nocs_train",
        "cub_train", "cub_eval")})
    launches["dp_world1"] = dp["world1"]["launches"]
    launches.update({f"dp_gloo_rank{rk['rank']}": rk["launches"]
                     for rk in dp["gloo"]["ranks"]})
    launches.update({f"dp_eval_rank{r}": n
                     for r, n in enumerate(dp["eval"]["launches"])})
    launches.update({"bf16_train": flags["bf16"]["launches"],
                     "bf16_log_images": flags["bf16"]["vis_launches"],
                     **flags["devsynth"]["launches"],
                     "profile": flags["profile"]["launches"]})
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
               "train_step_parity": parity, "train_paths": main_costs,
               "checkpoint": ckpt_res, "data": data, "data_parallel": dp,
               "flags": flags}
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
        if name in data["w6d_vis"]["costs"]:      # forward_vis, batch 2
            row["w6d_vis"] = dict(data["w6d_vis"]["costs"][name],
                                  max_abs_err=data["w6d_vis"]["max_abs_err"]
                                  [name])
        if name == "dino_flash_attn":     # at the bf16 trunk's views
            row["bf16_trunk_max_abs_err"] = flags["bf16"]["b3_max_abs_err"]
        if name in dp["gloo"]["ranks"][0]["max_abs_err"]:
            row["dp_gloo_max_abs_err"] = [
                rk["max_abs_err"][name] for rk in dp["gloo"]["ranks"]]
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
