"""Nothing the benchmark runs imports JAX, flax or the JAX package
(selfcorr_tpu), compared by whole top-level module names, so that the
port (selfcorr_tpu_torch) passes; and the reference imports nothing of
the port."""
from __future__ import annotations

import glob
import os
import re
import subprocess
import sys

from benchmark import run
from benchmark.harness.cell import BENCH_DIR, ROOT

IMPORT = re.compile(r"^\s*(from|import)\s+(selfcorr_tpu|jax|jaxlib|flax)\b",
                    re.M)
PROBE = r"""
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.control
import benchmark.harness.train, benchmark.harness.predict
from benchmark.tests.bench_tiny import tiny_run
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _modules_after(body: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "selfcorr_tpu_torch_probe", sys)
    assert "selfcorr_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "selfcorr_tpu.models", sys)
    assert run.forbidden_modules() == ["selfcorr_tpu"]


def test_a_run_loads_no_jax():
    """Two tiny runs of different traffic in one process, then every
    module's top-level name."""
    loaded = _modules_after(
        "assert tiny_run('laptop_predict')[0] == 0\n"
        "assert tiny_run('laptop_train')[0] == 0")
    assert "selfcorr_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    body = ("import importlib, pkgutil, benchmark.reference as R\n"
            "for m in pkgutil.walk_packages(R.__path__, 'benchmark.reference.'):"
            "\n    importlib.import_module(m.name)\n"
            "assert 'selfcorr_tpu_torch' not in sys.modules")
    probe = PROBE.replace("import benchmark.run, benchmark.control\n", "")
    probe = probe.replace("import benchmark.harness.train, "
                          "benchmark.harness.predict\n", "")
    probe = probe.replace("from benchmark.tests.bench_tiny import tiny_run\n",
                          "")
    out = subprocess.run([sys.executable, "-c",
                          probe.format(root=ROOT, body=body)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (set(run.FORBIDDEN) | {"selfcorr_tpu_torch"})
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            assert not IMPORT.search(f.read()), path
