"""Guards of the port: what it imports, and that it never runs on a device
it was not given.

The import check is static (an AST scan): the test interpreter imports JAX
at start-up, so a runtime sys.modules check could not tell."""
import ast
import glob
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
    names = {os.path.relpath(p, ROOT) for p in files}
    assert {"selfcorr_tpu_torch/train/step.py",
            "selfcorr_tpu_torch/train/optim.py",
            "selfcorr_tpu_torch/train/loop.py",
            "selfcorr_tpu_torch/models/vit.py",
            "selfcorr_tpu_torch/ops/attention.py",
            "selfcorr_tpu_torch/ops/knn.py",
            "selfcorr_tpu_torch/losses/regularizers.py",
            "selfcorr_tpu_torch/utils/cuda_build.py"} <= names
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


def test_train_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from selfcorr_tpu_torch.train.loop import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", "--flagfile", LAPTOP, "--dataset_name", "synthetic",
              "--total_iters", "1"])


@pytest.mark.parametrize("name", ["x.pth", "ckpt"])
def test_model_path_is_a_later_slice(tmp_path, name):
    """--model_path is ported (a reference .pth or a port checkpoint): a
    path that does not exist raises, and never leaves the weights drawn
    from --seed."""
    from selfcorr_tpu_torch.configs import Config
    from selfcorr_tpu_torch.eval.tester import Tester
    with pytest.raises(FileNotFoundError):
        Tester(Config(device="cpu", model_path=str(tmp_path / name),
                      checkpoint_dir=str(tmp_path)))


def test_only_synthetic_eval_data_is_ported(tmp_path):
    from selfcorr_tpu_torch.configs import Config
    from selfcorr_tpu_torch.eval.tester import make_test_dataset
    with pytest.raises(NotImplementedError, match="later slice"):
        make_test_dataset(Config(dataset_name="Wild6D"))


def test_kernel_is_not_built_at_import():
    """Importing the port (in a fresh interpreter) builds nothing."""
    code = ("import selfcorr_tpu_torch.eval.tester\n"
            "import selfcorr_tpu_torch.train.loop\n"
            "from selfcorr_tpu_torch.ops import attention\n"
            "from selfcorr_tpu_torch.ops.rasterizer import kernel\n"
            "from selfcorr_tpu_torch.utils import cuda_build\n"
            "assert kernel._lib is None and attention._fn is None\n"
            "assert not cuda_build._loaded\n"
            "assert '-gencode=arch=compute_90a,code=sm_90a' in "
            "kernel.CUDA_FLAGS\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


TINY = ["--dataset_name", "synthetic", "--img_size", "32", "--corr_h", "8",
        "--corr_w", "8", "--batch_size", "2", "--repeat", "2",
        "--pretrain_k", "8", "--n_corr_feat", "16", "--codedim", "8",
        "--symmetry_npts", "256", "--device", "cpu"]
_TRAIN, _EVAL = "Trainer", "Tester"
REFUSED = ([("num_devices", 2, e) for e in (_TRAIN, _EVAL)]
           + [("multihost", True, e) for e in (_TRAIN, _EVAL)]
           + [("coordinator_address", "localhost:1234", _TRAIN),
              ("num_processes", 2, _TRAIN), ("process_id", 0, _EVAL),
              ("profile_steps", 5, _TRAIN),
              ("synthetic_on_device", True, _TRAIN)]
           + [(f"visualize_{n}", True, _EVAL)
              for n in ("bbox", "match", "imatch", "conf", "mesh", "gt")])


def entry(name):
    from selfcorr_tpu_torch.eval.tester import Tester
    from selfcorr_tpu_torch.train.loop import Trainer
    return {_TRAIN: Trainer, _EVAL: Tester}[name]


@pytest.mark.parametrize("flag,value,cls", REFUSED)
def test_unported_flag_is_a_later_slice(flag, value, cls, tmp_path):
    """A flag asking for work the port does not do yet raises at the entry
    point that would do it, before anything is built."""
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(["--flagfile", LAPTOP, *TINY,
                      "--checkpoint_dir", str(tmp_path)]).replace(
        **{flag: value})
    with pytest.raises(NotImplementedError, match="later slice"):
        entry(cls)(cfg)


@pytest.mark.parametrize("flagfile", sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "config", "*", "*.txt"))))
def test_config_flag_files_ask_for_nothing_unported(flagfile):
    from selfcorr_tpu_torch.configs import parse_args, refuse_unported
    cfg = parse_args(["--flagfile", os.path.join(ROOT, flagfile)])
    refuse_unported(cfg, train=True)
    refuse_unported(cfg, train=False)


def test_defaults_and_ported_panels_still_construct(tmp_path, capsys):
    """The defaults with --vis_pred --visualize_{mask,tex,depth} (the
    predict path's panels) build a Trainer and a Tester on the CPU; the
    Trainer says that it logs no images."""
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(["--flagfile", LAPTOP, *TINY, "--vis_pred",
                      "--visualize_mask", "--visualize_tex",
                      "--visualize_depth", "--checkpoint_dir",
                      str(tmp_path)])
    trainer = entry(_TRAIN)(cfg)
    assert trainer.state.step == 0
    assert "logs no images" in capsys.readouterr().out
    tester = entry(_EVAL)(cfg.replace(train=False))
    assert tester.device.type == "cpu"
