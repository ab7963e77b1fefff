"""Batch assembly on the host (counterpart of selfcorr_tpu/data/loader.py).

TrainLoader: a producer thread decodes the next batches with a thread pool
while the device steps, and queues stacked numpy batches.
TestLoader: sequential fixed-size batches; the tail batch is padded by
repeating the last sample and carries a validity mask."""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

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


class TrainLoader:
    """Iterates cfg.total_iters - start batches of a dataset with
    sample_plan(step) -> [item args] and load_item(*args): each plan entry
    carries its item's random draws (a crop scale, CUB's box jitter), drawn
    in plan order, so the batches do not depend on which thread loads
    which item. host_transform,
    when given, is applied to each stacked batch in the producer thread
    (the compact-dtype packing). Call close() when done."""

    def __init__(self, dataset, cfg: Config, start: int = 0,
                 host_transform=None):
        self.dataset = dataset
        self.cfg = cfg
        self.start = start
        self.host_transform = host_transform
        self.pool = ThreadPoolExecutor(max(cfg.num_workers, 1))
        self.q: queue.Queue = queue.Queue(maxsize=2)  # batches ahead
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _submit(self, step: int):
        return [self.pool.submit(self.dataset.load_item, *args)
                for args in self.dataset.sample_plan(step)]

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        # the next step's decode jobs are in flight while the current batch
        # is stacked and queued
        total = self.cfg.total_iters
        try:
            pending = self._submit(self.start) if self.start < total else None
            for step in range(self.start, total):
                nxt = self._submit(step + 1) if step + 1 < total else None
                batch = stack_items([f.result() for f in pending])
                if self.host_transform is not None:
                    batch = self.host_transform(batch)
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
    __test__ = False  # not a pytest class

    def __init__(self, dataset, cfg: Config):
        self.dataset = dataset
        self.bsz = cfg.batch_size
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
                                                   idx)))
            batch["valid"] = valid
            yield batch

    def close(self):
        self.pool.shutdown(wait=True)
