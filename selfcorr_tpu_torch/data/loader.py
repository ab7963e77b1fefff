"""Batch assembly on the host (counterpart of selfcorr_tpu/data/loader.py).

TrainLoader: a producer thread keeps the next batch's items loading while
the device steps, and queues stacked numpy batches. The items load in a
pool of threads, or with cfg.loader_processes in a pool of worker processes
(spawn-started, each holding its own unpickled copy of the dataset), which
take the readers' decoding and crops out of the interpreter that launches
the training step.
TestLoader: sequential fixed-size batches; the tail batch is padded by
repeating the last sample and carries a validity mask.
Across ranks each loader takes a row_range, its [start, stop) of every
global batch (parallel.process_row_range): every rank walks the same plan
or batch schedule and loads only its own rows.

This module, the readers and configs import no torch, so a worker process
does not pay for it.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from selfcorr_tpu_torch.configs import Config

BATCH_KEYS = ("img", "mask", "depth", "occ", "pp_crop", "foc_crop")
_META_KEYS = ("center", "length", "foc", "pp", "idx", "frame_idx")
_GT_KEYS = ("rot_gt", "trans_gt", "scale_gt", "kp", "sfm_pose")


def stack_items(items):
    batch = {}
    for k in BATCH_KEYS + _META_KEYS + _GT_KEYS:
        if k in items[0]:
            batch[k] = np.stack([it[k] for it in items]).astype(
                np.asarray(items[0][k]).dtype)
    return batch


def compress_batch_host(batch: dict) -> dict:
    """Pack a host batch (or one item: it acts elementwise) into compact
    dtypes for upload: uint8 img, mask and occ, uint16 depth in millimetres
    rounded to nearest."""
    out = dict(batch)
    out["img"] = np.clip(np.asarray(batch["img"]) * 255.0 + 0.5,
                         0, 255).astype(np.uint8)
    out["mask"] = (np.asarray(batch["mask"]) > 0).astype(np.uint8)
    out["occ"] = (np.asarray(batch["occ"]) > 0).astype(np.uint8)
    out["depth"] = np.clip(np.asarray(batch["depth"]) + 0.5,
                           0, 65535).astype(np.uint16)
    return out


# a worker process's dataset and per-item transform, set once by
# _init_worker
_WORKER_DATASET = None
_WORKER_TRANSFORM = None


def _init_worker(blob: bytes):
    global _WORKER_DATASET, _WORKER_TRANSFORM
    _WORKER_DATASET, _WORKER_TRANSFORM = pickle.loads(blob)


def _worker_load(*args):
    item = _WORKER_DATASET.load_item(*args)
    if _WORKER_TRANSFORM is not None:
        item = _WORKER_TRANSFORM(item)
    return item


def _worker_ping(_):
    time.sleep(0.3)     # keeps the worker busy so the pool starts them all
    return os.getpid()


def process_pool(dataset, n: int, transform=None) -> ProcessPoolExecutor:
    """n spawn-started worker processes, each holding an unpickled copy of
    `dataset` and of `transform` (applied to each item it loads), all
    started before this returns. An unpicklable dataset, or a worker that
    cannot start, raises here. Spawn, not fork: a fork of a process that
    has initialised CUDA is broken, and the workers never touch CUDA. The
    workers re-import the parent's __main__, so an entry point that starts
    them must run from a file or a module."""
    blob = pickle.dumps((dataset, transform),
                        protocol=pickle.HIGHEST_PROTOCOL)
    pool = ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
        "spawn"), initializer=_init_worker, initargs=(blob,))
    try:
        list(pool.map(_worker_ping, range(n)))
    except BaseException:
        pool.shutdown(wait=True, cancel_futures=True)
        raise
    return pool


class TrainLoader:
    """Iterates cfg.total_iters - start batches of a dataset with
    sample_plan(step) -> [item args] and load_item(*args): each plan entry
    carries its item's random draws (a crop scale, CUB's box jitter), drawn
    in plan order in this process, so the batches do not depend on which
    thread or worker loads which item, nor on the arm.

    host_transform, when given, packs the batches (compress_batch_host).
    With cfg.num_workers threads it is applied to each stacked batch in the
    producer thread. With cfg.loader_processes the items load in as many
    worker processes (process_pool), which apply it to each item, so that
    only packed items come back (a quarter of the bytes): it must act
    elementwise and import no torch. A pool that cannot start raises, it
    does not fall back to threads. An exception in a worker, or a broken
    pool, is raised by the iteration. Call close() when done: it leaves no
    worker process alive.

    row_range [start, stop): the rows of each step's plan this rank loads.
    The whole plan is drawn all the same, so every rank's reader stays in
    step with the others'."""

    def __init__(self, dataset, cfg: Config, start: int = 0,
                 host_transform=None, row_range=None):
        self.dataset = dataset
        self.cfg = cfg
        self.start = start
        self.rows = slice(*row_range) if row_range else slice(None)
        n = max(cfg.num_workers, 1)
        if cfg.loader_processes:
            self.pool = process_pool(dataset, n, host_transform)
            self._load, self._transform = _worker_load, None
        else:
            self.pool = ThreadPoolExecutor(n)
            self._load, self._transform = dataset.load_item, host_transform
        self.q: queue.Queue = queue.Queue(maxsize=2)  # batches ahead
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _submit(self, step: int):
        return [self.pool.submit(self._load, *args)
                for args in self.dataset.sample_plan(step)[self.rows]]

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        # the next step's items are in flight while the current batch is
        # stacked and queued
        total = self.cfg.total_iters
        try:
            pending = self._submit(self.start) if self.start < total else None
            for step in range(self.start, total):
                nxt = self._submit(step + 1) if step + 1 < total else None
                batch = stack_items([f.result() for f in pending])
                if self._transform is not None:
                    batch = self._transform(batch)
                pending = nxt
                if not self._put(batch):
                    return
        except Exception as e:  # surfaced to the consumer by __iter__
            self._put(e)
            return
        self._put(None)

    def __iter__(self):
        while True:
            batch = self.q.get()
            if batch is None:
                return
            if isinstance(batch, Exception):
                raise batch
            yield batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)
        self.pool.shutdown(wait=True, cancel_futures=True)


class TestLoader:
    """Batches of cfg.batch_size samples in order (shuffled by cfg.seed with
    cfg.shuffle_test), the tail padded; with row_range [start, stop) only
    those rows of each batch, and of its `valid` mask, are loaded."""
    __test__ = False  # not a pytest class

    def __init__(self, dataset, cfg: Config, row_range=None):
        self.dataset = dataset
        self.bsz = cfg.batch_size
        self.rows = slice(*row_range) if row_range else slice(None)
        self.pool = ThreadPoolExecutor(max(cfg.num_workers, 1))
        order = np.arange(len(dataset))
        if cfg.shuffle_test:
            np.random.RandomState(cfg.seed).shuffle(order)
        self.order = order

    def __len__(self):
        return -(-len(self.dataset) // self.bsz)

    def __iter__(self):
        n = len(self.dataset)
        for start in range(0, n, self.bsz):
            idx = self.order[start: start + self.bsz]
            valid = np.ones(self.bsz, bool)
            if len(idx) < self.bsz:
                valid[len(idx):] = False
                idx = np.concatenate(
                    [idx, np.full(self.bsz - len(idx), idx[-1])])
            batch = stack_items(list(self.pool.map(self.dataset.load_item,
                                                   idx[self.rows])))
            batch["valid"] = valid[self.rows]
            yield batch

    def close(self):
        self.pool.shutdown(wait=True)
