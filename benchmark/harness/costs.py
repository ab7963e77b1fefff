"""The yardstick's arithmetic: the card's published peaks, the least time
of the port's kernels at their inputs (a frozen copy of the counting in
chip_smoke.py raster_costs / attn_costs) and the matrix work of a whole
training step, counted from shapes on the reference's step."""
from __future__ import annotations

import contextlib

import torch

# H100 SXM, NVIDIA's data sheet: float32 outside the tensor cores (TF32 is
# off in the configurations), dense bf16 on the tensor cores, HBM3
FP32_PEAK = 67e12
BF16_PEAK = 989e12
HBM_BW = 3.35e12

# fp32 operations per (face, pixel) pair by the work the pair does, the
# keys of the plain forward's pair_counts (chip_smoke.py OPS_PER_PAIR and
# OPS_PER_PAIR_BWD, counted from the kernels' per-pair code): forward
# "cover" 97 (barycentric planes, inside test, edge distances, cutoffs,
# clipped barycentrics and z), "cover1" / "cover2" 6 (a sigmoid and the
# coverage product), "tex" 34, "depth" 28; backward "cover" 172, "cover1"
# 37, "cover2" 43.
OPS_PER_PAIR = {"cover": 97, "cover1": 6, "cover2": 6, "tex": 34, "depth": 28}
OPS_PER_PAIR_BWD = {"cover": 172, "cover1": 37, "cover2": 43}
N_FWD_PLANES, N_BWD_PLANES = 13, 16


def pair_counts(consts: torch.Tensor, image_size: int, sigmas) -> dict:
    """The (face, pixel) pairs of a compact render that do each part of
    the work, from the reference's plain forward."""
    from benchmark.reference.ops.rasterizer.reference import \
        raster_fused_fwd_plain
    counts = {}
    with torch.no_grad():
        raster_fused_fwd_plain(consts, image_size, *sigmas, 0,
                               pair_counts=counts)
    return counts


def raster_bound_s(consts_shape, image_size: int, pairs: dict,
                   backward: bool) -> float:
    """The least time of B1 (or B2) at these inputs: the larger of the
    working pairs' operations over the fp32 peak and the bytes read and
    written once (constants; 13 planes out, or 16 planes in and the
    gradient out) over the HBM bandwidth."""
    b, f, k = consts_shape
    per = OPS_PER_PAIR_BWD if backward else OPS_PER_PAIR
    ops = sum(n * pairs[key] for key, n in per.items())
    planes = N_BWD_PLANES if backward else N_FWD_PLANES
    nbytes = b * f * k * 4 * (2 if backward else 1) \
        + planes * b * image_size * image_size * 4
    return max(ops / FP32_PEAK, nbytes / HBM_BW)


def attn_bound_s(shape) -> float:
    """The least time of B3 on (B, H, T, d) bf16 q, k, v: 4 B H T^2 d
    operations at the bf16 peak, or q, k, v read and o written once."""
    b, h, t, d = shape
    return max(4 * b * h * t * t * d / BF16_PEAK,
               4 * b * h * t * d * 2 / HBM_BW)


def attn_flops(cfg, batch: int, blocks: int = 9) -> int:
    """The attention products of the DINO trunk over a batch: q k^T and
    p v, 2 B H T^2 d each, in each of the blocks that attend (the tenth
    block only computes its keys)."""
    t = (cfg.img_size // 8) ** 2 + 1
    return blocks * 4 * batch * 6 * t * t * 64


@contextlib.contextmanager
def count_flops():
    """Counts the matrix work (matmuls, convolutions and their backward) of
    what runs inside, by shape, as torch.utils.flop_counter does; yields
    the counter (get_total_flops())."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        yield counter


def least_step_s(total_flops: int, bf16_flops: int) -> float:
    """The least time of a step's matrix work at the published peaks: the
    bf16 products (the trunk's attention, dino_attn_bf16) on the tensor
    cores, the rest in float32."""
    return (total_flops - bf16_flops) / FP32_PEAK + bf16_flops / BF16_PEAK
