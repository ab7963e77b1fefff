"""Nearest-neighbour and one-way chamfer distances (counterpart of
selfcorr_tpu/ops/knn.py, where XLA computes them outside any Pallas kernel).

The nearest index of each query point takes one of two routes: CUDA tensors
go to kernel B4 (csrc/nearest_point.cu), which keeps a running minimum per
query and never writes the (B, N, M) distance matrix; CPU tensors go to
`nearest_index_plain`, the matrix form in plain PyTorch. Either way the
distance is then recomputed from the gathered winner, so the gradient is the
same plain PyTorch on both routes. The build and the launch happen at the
first call, never at import."""
from __future__ import annotations

import ctypes
import os

import torch

from selfcorr_tpu_torch.utils import cuda_build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "nearest_point.cu")
# the kernel's block: THREADS threads of QUERIES_PER_THREAD queries each;
# targets in chunks of whole GROUPs
THREADS, QUERIES_PER_THREAD, GROUP = 128, 4, 8
BLOCK_QUERIES = THREADS * QUERIES_PER_THREAD
# the plan splits the targets across blocks until the grid has this many
# blocks per SM, into no more chunks than M / MIN_CHUNK rounded up
BLOCKS_PER_SM = 16
MIN_CHUNK = 512

# launches of the kernel, counted by its wrapper where it launches
LAUNCHES = {"nearest_point": 0}

_fn = None


def build():
    """Compile (once per process) and bind the kernel."""
    global _fn
    if _fn is None:
        fn = cuda_build.load(SOURCE).nearest_point
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(b: int, n: int, m: int, sms: int):
    """B4's grid for B batch elements of N queries and M targets on a card
    of `sms` SMs: (queries per block, targets per chunk, chunks). The
    queries of an element are spread evenly over the fewest blocks of at
    most BLOCK_QUERIES; the targets are split into chunks only while the
    grid has fewer than BLOCKS_PER_SM blocks per SM, into no more than
    M / MIN_CHUNK rounded up."""
    q_blocks = _cdiv(n, BLOCK_QUERIES)
    per_block = _cdiv(n, q_blocks)
    chunks = max(1, min(_cdiv(BLOCKS_PER_SM * sms, b * q_blocks),
                        _cdiv(m, MIN_CHUNK)))
    chunk = _cdiv(_cdiv(m, chunks), GROUP) * GROUP
    return per_block, chunk, _cdiv(m, chunk)


def _check(x, y, y_valid) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[-1] != 3 \
            or y.shape[-1] != 3:
        raise ValueError(f"x and y must be (B, N, 3) and (B, M, 3), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"x and y must have one batch size, got "
                         f"{x.shape[0]} and {y.shape[0]}")
    if y.shape[1] == 0:
        raise ValueError("y has no points")
    if y_valid is not None and tuple(y_valid.shape) != tuple(y.shape[:2]):
        raise ValueError(f"y_valid must be {tuple(y.shape[:2])}, got "
                         f"{tuple(y_valid.shape)}")
    for name, t in (("y", y), ("y_valid", y_valid)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def nearest_index_plain(x, y, y_valid=None) -> torch.Tensor:
    """(B, N) int64 index of each x point's nearest y point, from the
    materialized |x|^2 + |y|^2 - 2 x.y; masked y points never win unless
    all are masked (then index 0)."""
    with torch.no_grad():
        xs, ys = x.detach().float(), y.detach().float()
        d2v = ((xs * xs).sum(-1)[:, :, None] + (ys * ys).sum(-1)[:, None, :]
               - 2.0 * torch.matmul(xs, ys.transpose(1, 2)))
        if y_valid is not None:
            d2v = torch.where(y_valid[:, None, :] > 0, d2v, float("inf"))
        return d2v.argmin(dim=-1)


def nearest_index_cuda(x, y, y_valid=None) -> torch.Tensor:
    """Kernel B4 on CUDA tensors: the same index as nearest_index_plain,
    from distances computed as (x - y)^2 in fp32, the lower index winning
    a tie. Works on its own contiguous fp32 copies of the inputs."""
    if not x.is_cuda:
        raise ValueError(f"kernel B4 takes CUDA tensors, got {x.device}")
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    if max(b, n, m) >= 2 ** 31 or b > 65535:
        raise ValueError(f"B4 takes B <= 65535 and N, M < 2^31, got "
                         f"{(b, n, m)}")
    xs = x.detach().float().contiguous()
    ys = y.detach().float().contiguous()
    vs = None if y_valid is None else y_valid.detach().float().contiguous()
    per_block, chunk, chunks = plan(b, n, m, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    out = torch.empty((b, n), dtype=torch.int64, device=x.device)
    part_d = part_i = None
    if chunks > 1:
        part_d = torch.empty((chunks, b, n), dtype=torch.float32,
                             device=x.device)
        part_i = torch.empty((chunks, b, n), dtype=torch.int32,
                             device=x.device)
    fn = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xs.data_ptr(), ys.data_ptr(),
                None if vs is None else vs.data_ptr(), out.data_ptr(),
                None if part_d is None else part_d.data_ptr(),
                None if part_i is None else part_i.data_ptr(),
                b, n, m, per_block, chunk, chunks, stream)
    if rc != 0:
        raise RuntimeError(f"nearest_point launch failed: CUDA error {rc}")
    LAUNCHES["nearest_point"] += 1
    return out


def nearest_index(x, y, y_valid=None) -> torch.Tensor:
    """(B, N) int64 index into y (B, M, 3) of each x (B, N, 3) point's
    nearest point; y_valid (B, M) masks y. See the module docstring for
    the routes."""
    _check(x, y, y_valid)
    if x.device.type == "cuda":
        return nearest_index_cuda(x, y, y_valid)
    if x.device.type == "cpu":
        return nearest_index_plain(x, y, y_valid)
    raise ValueError(f"no nearest-point search on {x.device}")


def min_sq_dist(x: torch.Tensor, y: torch.Tensor,
                y_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point squared distance from x (B, N, 3) to its nearest point of
    y (B, M, 3); y_valid (B, M) masks y. Returns (B, N).

    The nearest index comes without gradient (nearest_index); the distance
    is then recomputed exactly from the gathered winner, so the gradient is
    that of a min with the argmin held fixed."""
    idx = nearest_index(x, y, y_valid)
    ynn = torch.gather(y.float(), 1, idx[..., None].expand(-1, -1, 3))
    out = ((x.float() - ynn) ** 2).sum(-1)
    if y_valid is not None:
        vnn = torch.gather(y_valid.float(), 1, idx)
        out = torch.where(vnn > 0, out, float("inf"))
    return torch.clamp(out, min=0.0)


def chamfer_single_way(x, y, x_valid=None, y_valid=None,
                       point_reduction: str | None = "mean",
                       batch_reduction: str | None = "mean"):
    """One-way chamfer: mean over x of the squared distance to the nearest
    y, then mean over the batch."""
    d2 = min_sq_dist(x, y, y_valid)
    if x_valid is not None:
        d2 = d2 * x_valid.to(d2.dtype)
        denom = torch.clamp(x_valid.sum(-1), min=1.0)
    else:
        denom = x.shape[1]
    if point_reduction is None:
        return d2
    per_batch = d2.sum(-1) / denom
    if batch_reduction is None:
        return per_batch
    return per_batch.mean()
