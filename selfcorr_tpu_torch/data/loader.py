"""Eval batch assembly on the host (counterpart of the TestLoader of
selfcorr_tpu/data/loader.py): sequential fixed-size batches of stacked numpy
arrays; the tail batch is padded by repeating the last sample and carries a
validity mask."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from selfcorr_tpu_torch.configs import Config

BATCH_KEYS = ("img", "mask", "depth", "occ", "pp_crop", "foc_crop")
_META_KEYS = ("center", "length", "foc", "pp", "idx", "frame_idx")
_GT_KEYS = ("rot_gt", "trans_gt", "scale_gt")


def stack_items(items):
    batch = {}
    for k in BATCH_KEYS + _META_KEYS + _GT_KEYS:
        if k in items[0]:
            batch[k] = np.stack([it[k] for it in items]).astype(
                np.asarray(items[0][k]).dtype)
    return batch


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
