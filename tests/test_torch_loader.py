"""The TrainLoader's worker-process arm (--loader_processes) against its
thread arm, on the CPU with 2 spawn-started workers.

Bit for bit: every batch's keys, dtypes and values, on the synthetic
videos and on Wild6D and CUB fixture trees (data/fixtures.py), packed by
compress_batch_host and unpacked, from step 0 and from a later start (a
resumed run). Then the failures: a worker's exception and a broken pool
reach the consumer, an unpicklable dataset raises and falls back to
nothing, and no worker outlives close(). Also CUB's numpy
matrix_to_quat, which keeps torch out of the workers, against the torch
one, bit for bit."""
import multiprocessing
import os
import signal

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from selfcorr_tpu_torch.configs import Config
from selfcorr_tpu_torch.data import cub as B
from selfcorr_tpu_torch.data import fixtures as FX
from selfcorr_tpu_torch.data.loader import TrainLoader, compress_batch_host
from selfcorr_tpu_torch.ops.geometry import matrix_to_quat
from selfcorr_tpu_torch.train.loop import make_train_dataset
from test_torch_threads import share_cores  # noqa: F401 (autouse)


def children():
    return set(multiprocessing.active_children())


SMALL = dict(img_size=32, batch_size=2, repeat=2, num_workers=2,
             total_iters=4)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """name -> Config of a synthetic, a Wild6D and a CUB training set."""
    d = tmp_path_factory.mktemp("loader")
    w6d_root, _ = FX.wild6d_tree(str(d / "w6d"), n_train_videos=2,
                                 n_test_videos=0, frames_per_video=4,
                                 raw_size=48)
    w6d_list = str(d / "w6d_train.txt")
    FX.write_list(w6d_root, w6d_list)
    cub_root = str(d / "cub" / "cub")
    cub_list = FX.cub_tree(cub_root, per_class=3, split="train")
    return {"synthetic": Config(dataset_name="synthetic", **SMALL),
            "wild6d": Config(dataset_name="Wild6D", dataset_path=w6d_root,
                             train_list=w6d_list, use_depth=True, **SMALL),
            "cub": Config(dataset_name="cub", dataset_path=cub_root,
                          train_list=cub_list, **SMALL)}


def batches(cfg, processes: bool, start: int, pack: bool):
    loader = TrainLoader(make_train_dataset(cfg),
                         cfg.replace(loader_processes=processes),
                         start=start,
                         host_transform=compress_batch_host if pack else None)
    try:
        return list(loader)
    finally:
        loader.close()


@pytest.mark.parametrize("name", ["synthetic", "wild6d", "cub"])
@pytest.mark.parametrize("start,pack", [(0, True), (2, False)])
def test_process_batches_equal_thread_batches(trees, name, start, pack):
    cfg = trees[name]
    before = children()
    want = batches(cfg, False, start, pack)
    got = batches(cfg, True, start, pack)
    assert len(got) == len(want) == cfg.total_iters - start
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, \
                (i, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    assert want[0]["img"].dtype == (np.uint8 if pack else np.float32)
    assert children() <= before


def test_worker_exception_reaches_the_consumer(trees, tmp_path):
    """A frame missing on disk: the worker's FileNotFoundError is raised
    by the iteration."""
    cfg = trees["wild6d"]
    before = children()
    ds = make_train_dataset(cfg)
    ds.videos.videos[0]["imgs"] = [str(tmp_path / "gone.jpg")] * len(
        ds.videos.videos[0]["imgs"])
    loader = TrainLoader(ds, cfg.replace(loader_processes=True,
                                         batch_size=4, repeat=1))
    try:
        with pytest.raises(FileNotFoundError, match="gone.jpg"):
            list(loader)
    finally:
        loader.close()
    assert children() <= before


def test_broken_pool_reaches_the_consumer(trees):
    from concurrent.futures.process import BrokenProcessPool
    cfg = trees["synthetic"]
    before = children()
    loader = TrainLoader(make_train_dataset(cfg),
                         cfg.replace(loader_processes=True, total_iters=50))
    try:
        for pid in list(loader.pool._processes):
            os.kill(pid, signal.SIGKILL)
        with pytest.raises(BrokenProcessPool):
            list(loader)
    finally:
        loader.close()
    assert children() <= before


def test_unpicklable_dataset_raises_without_falling_back(trees):
    cfg = trees["synthetic"].replace(loader_processes=True)
    ds = make_train_dataset(cfg)
    ds.hook = lambda: None
    before = children()
    with pytest.raises(Exception, match="pickle|local object"):
        TrainLoader(ds, cfg)
    assert children() <= before


def test_close_leaves_no_worker(trees):
    """close() part way through the batches, the producer still loading."""
    cfg = trees["synthetic"].replace(loader_processes=True, total_iters=20)
    before = children()
    loader = TrainLoader(make_train_dataset(cfg), cfg)
    assert len(children() - before) == cfg.num_workers
    next(iter(loader))
    loader.close()
    assert children() <= before


def test_cub_matrix_to_quat_equals_torch():
    """The CUB reader's numpy copy and ops/geometry.matrix_to_quat, bit for
    bit: random rotations, perturbed ones, and rotations by about pi about
    each axis (every Shepperd branch, w near 0)."""
    rng = np.random.RandomState(0)
    mats = [Rotation.random(500, random_state=rng).as_matrix()]
    mats.append(mats[0] + rng.randn(500, 3, 3) * 0.01)
    for axis in np.eye(3):
        mats.append(Rotation.from_rotvec(
            np.outer([np.pi, np.pi - 1e-3, -np.pi + 1e-3], axis)).as_matrix())
    R = np.concatenate(mats).astype(np.float32)
    want = matrix_to_quat(torch.from_numpy(R)).numpy()
    got = np.stack([B.matrix_to_quat(r) for r in R])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
