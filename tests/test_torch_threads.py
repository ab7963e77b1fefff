"""The CPU threads of the port's tests, shared between pytest-xdist's
workers (`share_cores`), and its own tests.

Under `-n 6` on 8 cores every worker's torch runs an 8-thread pool, and each
process a test starts another, so some 50 threads spin on 8 cores: in the
tier-1 run tests/test_torch_checkpoint.py took 536 s of test time, against
14 s alone. A test file that imports `share_cores` (an autouse fixture of
module scope) runs its tests with its worker's share of the cores,
os.cpu_count() // PYTEST_XDIST_WORKER_COUNT and at least 1, in torch and,
through OMP_NUM_THREADS, in the processes its tests start (`thread_env` for
an environment built beforehand); both are restored after the file. Outside
xdist nothing changes.

Every port test file imports it (a guard below holds that) but
test_torch_threads.py, which defines it, test_torch_parity.py, which
predates the port, and the files whose tolerances against the JAX train step
were measured at torch's default thread count (test_torch_train_step.py,
test_torch_surface.py, test_torch_raster_chunk.py): oneDNN blocks its
convolutions' sums by thread count, and at one thread the seed-0 step's
rotation head misses their 2e-3 bound by up to 1.2x (ROADMAP C.13 records
why such a leaf moves with the rounding).
"""
import contextlib
import glob
import os

import pytest
import torch


def worker_threads(env=None, cores=None) -> int | None:
    """This xdist worker's share of the cores, or None outside xdist (or
    with one worker)."""
    env = os.environ if env is None else env
    workers = int(env.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 1:
        return None
    return max(1, (cores or os.cpu_count() or 1) // workers)


def thread_env() -> dict:
    """{"OMP_NUM_THREADS": share} under xdist, else {}: for the environment
    of a process a test starts."""
    n = worker_threads()
    return {} if n is None else {"OMP_NUM_THREADS": str(n)}


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads and OMP_NUM_THREADS set to n, then
    restored."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    n = worker_threads()
    with (torch_threads(n) if n is not None else contextlib.nullcontext()):
        yield


@pytest.mark.parametrize("workers,cores,want", [
    (None, 8, None), ("1", 8, None), ("6", 8, 1), ("2", 8, 4), ("4", 16, 4),
    ("12", 8, 1)])
def test_worker_threads_share_the_cores(workers, cores, want):
    env = {} if workers is None else {"PYTEST_XDIST_WORKER_COUNT": workers}
    assert worker_threads(env, cores) == want


def test_torch_threads_sets_and_restores(monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "64")
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    before = torch.get_num_threads()
    with torch_threads(worker_threads()):
        assert torch.get_num_threads() == 1
        assert os.environ["OMP_NUM_THREADS"] == "1"
        assert thread_env() == {"OMP_NUM_THREADS": "1"}
    assert torch.get_num_threads() == before
    assert "OMP_NUM_THREADS" not in os.environ


# the port's test files that keep torch's default threads (see above)
DEFAULT_THREADS = {"test_torch_train_step.py", "test_torch_surface.py",
                   "test_torch_raster_chunk.py"}


def test_every_port_test_file_shares_the_cores():
    here = os.path.dirname(os.path.abspath(__file__))
    files = {os.path.basename(p)
             for p in glob.glob(os.path.join(here, "test_torch_*.py"))}
    assert DEFAULT_THREADS <= files
    line = "from test_torch_threads import share_cores  # noqa: F401 (autouse)"
    missing = sorted(
        f for f in files - DEFAULT_THREADS
        - {"test_torch_threads.py", "test_torch_parity.py"}
        if line not in open(os.path.join(here, f)).read().splitlines())
    assert not missing, missing
