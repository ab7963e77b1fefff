"""Guards of the port: what it imports, and that it never runs on a device
it was not given.

The import check is static (an AST scan): the test interpreter imports JAX
at start-up, so a runtime sys.modules check could not tell."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "selfcorr_tpu"}
LAPTOP = os.path.join(ROOT, "config/wild6d/laptop.txt")


def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "selfcorr_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_cv2_or_jax_package():
    files = port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_import_scan_catches_forbidden_imports(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom selfcorr_tpu.ops import "
                 "geometry\nimport importlib\nimportlib.import_module('cv2')\n"
                 "from selfcorr_tpu_torch.ops import geometry\n")
    assert set(imported_roots(str(p))) & FORBIDDEN == {"jax", "selfcorr_tpu",
                                                      "cv2"}


def test_predict_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from selfcorr_tpu_torch import predict
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.main(["predict", "--flagfile", LAPTOP,
                      "--dataset_name", "synthetic"])


def test_model_path_is_a_later_slice(tmp_path):
    from selfcorr_tpu_torch.configs import Config
    from selfcorr_tpu_torch.eval.tester import Tester
    with pytest.raises(NotImplementedError, match="later slice"):
        Tester(Config(device="cpu", model_path="x.pth",
                      checkpoint_dir=str(tmp_path)))


def test_only_synthetic_eval_data_is_ported(tmp_path):
    from selfcorr_tpu_torch.configs import Config
    from selfcorr_tpu_torch.eval.tester import make_test_dataset
    with pytest.raises(NotImplementedError, match="later slice"):
        make_test_dataset(Config(dataset_name="Wild6D"))


def test_kernel_is_not_built_at_import():
    """Importing the port (in a fresh interpreter) builds nothing."""
    code = ("import selfcorr_tpu_torch.eval.tester\n"
            "from selfcorr_tpu_torch.ops.rasterizer import kernel\n"
            "assert kernel._lib is None\n"
            "assert '-gencode=arch=compute_90a,code=sm_90a' in "
            "kernel.CUDA_FLAGS\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
