#!/usr/bin/env python
"""On-card smoke test of the PyTorch/CUDA port (selfcorr_tpu_torch).

  python3 chip_smoke.py        # needs one CUDA GPU; exits non-zero without

Phases, in order; any failure exits non-zero:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile the fused-rasterizer forward kernel from the repo's
              source (ops/rasterizer/csrc/raster_fwd.cu)
  3. kernel   hold the kernel against its plain PyTorch version on the card,
              all 13 planes, at (a) the panel shape B=1 S=320 (laptop
              prior), (b) the training-render shape B=8 S=256 (laptop prior
              under 8 poses; icosphere(3) scattered scene), (c) edge cases
  4. slice    the predict path (selfcorr_tpu_torch.predict.main) on cuda at
              Wild6D-laptop width on the synthetic eval set with the render
              panels; launch counts are zeroed just before and read just
              after; then warm predict_batch FPS at batch 16 and forward_test
              on the card vs on the CPU
  5. report   one JSON line per the kernel table, then the result line

Tolerances (kernel vs plain): alpha 2e-3, depth 1.4e-2 absolute; tex /
match 3.8e-3 relative to max(1, |plain|), which is absolute for colours in
[0, 1] and relative for the depth panel's render, whose "texture" is posed
vertex coordinates (the on-chip gate's bounds of the JAX package; the
sigma=1e-4 sigmoid amplifies rounding ~1e4x at edges); the softmax max planes
m_d / m_t 1e-4 absolute; the softmax sum planes s_d / s_t 1e-3 relative to
max(1, |s|) (with gamma = 1e-4 one ulp of depth moves a softmax weight by
~1e-3).
"""
from __future__ import annotations

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
# cores, HBM3 bandwidth
FP32_PEAK = 67e12
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

def compare(ko, po):
    """Max |kernel - plain| per plane, and the planes over tolerance."""
    errs, bad = {}, []
    for n, ref in po.items():
        d = (ko[n] - ref).abs()
        if n in REL_TOL:
            lim = REL_TOL[n] * torch.clamp(ref.abs(), min=1.0)
        else:
            lim = TOL[n]
        errs[n] = float(d.max()) if d.numel() else 0.0
        if not (bool((d <= lim).all()) and bool(torch.isfinite(ko[n]).all())):
            bad.append(n)
    return errs, bad


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_costs(consts, s, sigma1, sigma2, gamma_d, gamma_t):
    """Kernel and plain times, and the bound: the larger of the operations
    these inputs need (pairs of each kind, counted by the plain version,
    times OPS_PER_PAIR) over the fp32 peak, and the constants read once plus
    13 planes written once over HBM bandwidth."""
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_plain
    args = (consts, s, sigma1, sigma2, gamma_d, gamma_t)
    ms = time_ms(lambda: KR.raster_fused_fwd_cuda(*args))
    plain_ms = time_ms(lambda: raster_fused_fwd_plain(*args), reps=5,
                       warmup=1)
    pairs = {}
    raster_fused_fwd_plain(*args, pair_counts=pairs)
    ops = sum(OPS_PER_PAIR[k] * n for k, n in pairs.items())
    b, f, k = consts.shape
    nbytes = b * f * k * 4 + 13 * b * s * s * 4
    t_ops = ops / FP32_PEAK * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return dict(ms=ms, plain_ms=plain_ms, pairs=pairs, ops=ops, bytes=nbytes,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(rng, dev):
    from selfcorr_tpu_torch.ops.rasterizer import common as C
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_plain
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
            ko = KR.raster_fused_fwd_cuda(consts, s, *sg)
            po = raster_fused_fwd_plain(consts, s, *sg)
            torch.cuda.synchronize()
            errs, bad = compare(ko, po)
            tag = f"{name} gamma_t={sg[3]:g}"
            print(f"[kernel] {tag}: F={consts.shape[1]} max|err| "
                  + " ".join(f"{n}={e:.3g}" for n, e in errs.items()),
                  flush=True)
            if bad:
                failures.append(f"{tag}: {bad}")
            if timed:
                c = kernel_costs(consts, s, *sg)
                timings[name] = c
                print(f"[kernel] {tag}: kernel {c['ms']} ms, plain "
                      f"{c['plain_ms']} ms, bound {c['bound_ms']} ms "
                      f"({c['bound_by']}; {c['ops']} operations over pairs "
                      f"{c['pairs']}; {c['bytes']} bytes)", flush=True)
    if failures:
        fail("kernel disagrees with its plain version: "
             + "; ".join(failures))
    return timings


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
    captured = []
    launch = KR.raster_fused_fwd_cuda

    def spy(consts, *a):
        captured.append((consts.clone(), a))
        return launch(consts, *a)

    KR.raster_fused_fwd_cuda = spy
    KR.reset_launches()
    t0 = time.time()
    try:
        results = predict.main(["predict"] + run_args)
    finally:
        KR.raster_fused_fwd_cuda = launch
    torch.cuda.synchronize()
    launches = dict(KR.LAUNCHES)
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
    return cfg, launches, captured


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

    breakdown = profile_predict(tester, batch)

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


def profile_predict(tester, batch, reps=3):
    """Where a warm predict_batch spends its time: device time by kernel
    and by PyTorch op over `reps` calls (torch.profiler), and the share of
    the calls' wall time in which the device ran a kernel. The full table
    goes to chiprun_out/chip_smoke/predict_profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            tester.predict_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / reps
    avg = prof.key_averages()
    with open(os.path.join(OUT, "predict_profile.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=60))

    def top(events, n=10):
        ev = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
        return [(e.key[:70], e.self_device_time_total / 1e3 / reps,
                 e.count // reps) for e in ev if e.self_device_time_total > 0]

    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    ops = [e for e in avg if e.device_type == DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    print(f"[profile] predict_batch: {wall_ms:.2f} ms wall per batch, "
          f"device busy {busy_ms:.2f} ms "
          f"({100.0 * busy_ms / wall_ms:.1f}%)", flush=True)
    by_kernel, by_op = top(kernels), top(ops)
    for name, ms, n in by_op:
        print(f"[profile] op {ms:8.3f} ms x{n:<4d} {name}")
    for name, ms, n in by_kernel:
        print(f"[profile] kernel {ms:8.3f} ms x{n:<4d} {name}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "by_op": by_op, "by_kernel": by_kernel}


def main() -> int:
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
    from selfcorr_tpu_torch.ops.rasterizer import kernel as KR
    from selfcorr_tpu_torch.utils.device import set_fp32_precision
    set_fp32_precision()

    phase("build")
    t0 = time.time()
    KR.build()
    print(f"[build] raster_fwd.cu built and bound in {time.time() - t0:.2f} s",
          flush=True)

    phase("kernel vs plain version")
    rng = np.random.RandomState(0)
    timings = kernel_phase(rng, dev)

    phase("predict slice")
    cfg, launches, captured = slice_phase()
    per_batch, fps, breakdown = fps_and_cpu_parity(cfg, smi)

    phase("report")
    from selfcorr_tpu_torch.ops.rasterizer.reference import \
        raster_fused_fwd_plain
    # every launch of the main path, texture and depth-panel renders alike,
    # against the plain version on the same inputs
    errs, bad = {}, []
    for i, (consts, a) in enumerate(captured):
        ko = KR.raster_fused_fwd_cuda(consts, *a)
        po = raster_fused_fwd_plain(consts, *a)
        e, over = compare(ko, po)
        errs = {n: max(v, errs.get(n, 0.0)) for n, v in e.items()}
        bad += [f"launch {i}: {n}" for n in over]
    print(f"[report] {len(captured)} main-path launches vs plain, max|err| "
          + " ".join(f"{n}={e:.3g}" for n, e in errs.items()), flush=True)
    if bad:
        fail(f"kernel disagrees at the main path's inputs: {bad}")
    consts, a = captured[0]
    main_cost = kernel_costs(consts, *a)
    print(f"[report] main-path inputs: B={consts.shape[0]} F="
          f"{consts.shape[1]} S={a[0]}; kernel {main_cost['ms']} ms, "
          f"plain {main_cost['plain_ms']} ms, bound {main_cost['bound_ms']} "
          f"ms ({main_cost['bound_by']}; {main_cost['ops']} operations over "
          f"pairs {main_cost['pairs']})")
    summary = {"card": smi, "predict_ms_per_batch": per_batch * 1e3,
               "predict_fps_batch16": fps, "predict_profile": breakdown,
               "launches": launches,
               "kernel_at_scenes": timings, "kernel_main_path": main_cost,
               "main_path_max_abs_err": errs}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": [{
        "name": "raster_fused_fwd", "route": "cuda",
        "source": "selfcorr_tpu_torch/ops/rasterizer/csrc/raster_fwd.cu",
        "replaces": "selfcorr_tpu/ops/rasterizer/pallas_raster.py:806",
        "launches": launches["raster_fused_fwd"],
        "max_abs_err": max(errs.values()),
        "ms": main_cost["ms"], "plain_ms": main_cost["plain_ms"],
        "bound_ms": main_cost["bound_ms"],
        "bound_by": main_cost["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
