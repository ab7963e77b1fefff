"""Guards of the port: what it imports, and that it never runs on a device
it was not given.

The import check is static (an AST scan): the test interpreter imports JAX
at start-up, so a runtime sys.modules check could not tell."""
import ast
import glob
import json
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
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
            "selfcorr_tpu_torch/utils/cuda_build.py",
            "selfcorr_tpu_torch/parallel/__init__.py"} <= names
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
    """Wild6D, NOCS, CUB and the synthetic set are ported; any other
    dataset name raises ValueError at both entry points' dataset makers,
    as in the JAX package."""
    from selfcorr_tpu_torch.configs import Config
    from selfcorr_tpu_torch.eval.tester import make_test_dataset
    from selfcorr_tpu_torch.train.loop import make_train_dataset
    for make in (make_test_dataset, make_train_dataset):
        with pytest.raises(ValueError, match="unknown dataset 'kitti'"):
            make(Config(dataset_name="kitti"))


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
def entry(name):
    from selfcorr_tpu_torch.eval.tester import Tester
    from selfcorr_tpu_torch.train.loop import Trainer
    return {_TRAIN: Trainer, _EVAL: Tester}[name]


def test_profile_steps_traces_the_window(tmp_path, capsys, monkeypatch):
    """--profile_steps N traces steps 11 to 10 + N (0-based, the log's
    step - 1) into <run>/trace as a Chrome trace. A run with N = 1 to step
    11 closes the window; one with N = 5 ends inside it, writes the steps it
    traced and says so. Both start at step 10, where the window opens, and
    write no checkpoint; the cycle losses are off (the loop is under
    test)."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.train import loop
    from selfcorr_tpu_torch.utils.logging import NoopWriter
    # the scalar writer would import TensorFlow here (~15 s)
    monkeypatch.setattr(loop, "make_writer", lambda run_dir: NoopWriter())
    monkeypatch.setattr(loop.Trainer, "save", lambda self, step: None)
    cfg = parse_args(
        ["--flagfile", LAPTOP, *TINY, "--checkpoint_dir", str(tmp_path),
         "--num_workers", "2", "--total_iters", "12",
         "--batch_log_interval", "100", "--subdivide", "1",
         "--cycle_loss_wt", "0", "--cycle_loss_pretrain_wt", "0"])
    trainer = entry(_TRAIN)(cfg)
    trace = os.path.join(trainer.run_dir, "trace")
    for n, ended in ((1, False), (5, True)):
        trainer.cfg = cfg.replace(profile_steps=n)
        trainer.state.step, trainer.trace_path = 10, None
        shutil.rmtree(trace, ignore_errors=True)
        trainer.train()
        assert os.listdir(trace) == ["steps_11-11.json"]
        assert trainer.trace_path == os.path.join(trace, "steps_11-11.json")
        with open(trainer.trace_path) as f:
            assert json.load(f)["traceEvents"]
        out = capsys.readouterr().out
        assert ("ended inside the window" in out) == ended


_COORD = "127.0.0.1:29999"
# device and process flags that do not hold together: ValueError at both
# entry points, before anything is built
INCOHERENT = [
    (dict(num_processes=2), "come together"),
    (dict(process_id=0), "come together"),
    (dict(coordinator_address=_COORD, num_processes=2), "come together"),
    (dict(num_devices=3, num_processes=2, process_id=0,
          coordinator_address=_COORD), "not a multiple"),
    (dict(num_devices=2, num_processes=2, process_id=2,
          coordinator_address=_COORD), "out of range"),
    (dict(num_devices=0), "at least 1"),
]


@pytest.mark.parametrize("flags,match", INCOHERENT)
@pytest.mark.parametrize("cls", [_TRAIN, _EVAL])
def test_parallel_flags_that_do_not_hold_together(flags, match, cls,
                                                  tmp_path):
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(["--flagfile", LAPTOP, *TINY,
                      "--checkpoint_dir", str(tmp_path)]).replace(**flags)
    with pytest.raises(ValueError, match=match):
        entry(cls)(cfg)
    assert not os.listdir(tmp_path)


_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
             "MASTER_PORT")


def test_multihost_needs_torchrun_environment(monkeypatch):
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch.configs import Config
    for k in _TORCHRUN:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        P.layout(Config(device="cpu", multihost=True))


def test_more_cuda_ranks_than_gpus_raise():
    """One rank per GPU: asking for more local CUDA ranks than the machine
    has raises (the JAX Trainer clamps --num_devices to the devices it
    sees)."""
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch.configs import Config
    n = max(torch.cuda.device_count() + 1, 2)
    with pytest.raises(ValueError, match="GPU"):
        P.layout(Config(num_devices=n))
    with pytest.raises(ValueError, match="GPU"):
        P.layout(Config(num_devices=2 * n, num_processes=2, process_id=1,
                        coordinator_address=_COORD))


def test_cuda_ranks_without_nccl_raise():
    import torch.distributed as dist
    from selfcorr_tpu_torch import parallel as P
    if dist.is_nccl_available():
        pytest.skip("this PyTorch has NCCL")
    with pytest.raises(RuntimeError, match="NCCL"):
        P.init_distributed(0, 1, _COORD, device="cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("cls", [_TRAIN, _EVAL])
def test_ranks_start_through_launch(cls, tmp_path):
    """A Trainer or Tester asked for several ranks without being given its
    rank raises: the entry points start the ranks (parallel.launch)."""
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(["--flagfile", LAPTOP, *TINY, "--num_devices", "2",
                      "--checkpoint_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="parallel.launch"):
        entry(cls)(cfg)


@pytest.mark.parametrize("flags,env,want", [
    (dict(), {}, None),
    (dict(num_devices=2), {}, (2, 0, ("cpu", "cpu"), "")),
    (dict(num_devices=4, num_processes=2, process_id=1,
          coordinator_address=_COORD), {},
     (4, 2, ("cpu", "cpu"), f"tcp://{_COORD}")),
    (dict(multihost=True), dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1",
                                MASTER_ADDR="10.0.0.1", MASTER_PORT="1"),
     (4, 3, ("cpu",), "env://")),
], ids=["one_device", "num_devices", "num_processes", "multihost"])
def test_parallel_flags_lay_out_ranks(flags, env, want, monkeypatch):
    """--num_devices is the world size; the multi-process flags give this
    process's share of the ranks; --multihost takes torchrun's."""
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch.configs import Config
    for k in _TORCHRUN:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    lay = P.layout(Config(device="cpu", **flags))
    assert (lay if lay is None else (lay.world, lay.first, lay.devices,
                                     lay.init_method)) == want


@pytest.mark.parametrize("how", ["process_flags", "multihost"])
def test_world_of_one_trains_through_a_group(how, tmp_path, monkeypatch):
    """--num_processes 1 --process_id 0 --coordinator_address, or
    --multihost under torchrun's variables for one rank: the train entry
    point runs its one rank in this process through a gloo group of one,
    trains, and leaves no group behind."""
    import torch.distributed as dist
    from selfcorr_tpu_torch import parallel as P
    from selfcorr_tpu_torch.train.loop import main
    port = P.free_port()
    if how == "multihost":
        for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)
                         ).items():
            monkeypatch.setenv(k, v)
        flags = ["--multihost"]
    else:
        flags = ["--num_processes", "1", "--process_id", "0",
                 "--coordinator_address", f"127.0.0.1:{port}"]
    seen = []
    real = P.all_mean_

    def spy(tensors, group=None):
        seen.append(dist.get_world_size(group))
        return real(tensors, group)
    monkeypatch.setattr("selfcorr_tpu_torch.train.step.all_mean_", spy)
    trainer = main(["train", "--flagfile", LAPTOP, *TINY, *flags,
                    "--total_iters", "1", "--batch_log_interval", "1",
                    "--num_workers", "2", "--checkpoint_dir",
                    str(tmp_path)])
    assert trainer.state.step == 1 and seen == [1]
    assert all(np.isfinite(v) for v in trainer.logged[0][1].values())
    assert not dist.is_initialized()


# the flags that refused until their modules landed, and the files each
# makes an evaluation write (<video>_<frame><suffix>)
PANELS = {"bbox": ("_bbox.png",), "match": ("_match.png",),
          "imatch": ("_imatch.png",), "conf": ("_conf.png",),
          "mesh": ("_mesh.obj",), "gt": ("_gt.png", "_depth_gt.png")}
PORTED = (["loader_processes"] + [f"visualize_{n}" for n in PANELS]
          + ["vis_pred"])


@pytest.mark.parametrize("flag", PORTED)
def test_ported_flag_does_its_work(flag, tmp_path):
    """Each flag that refused until its module landed builds its Trainer or
    Tester on the CPU and does its work: --loader_processes trains a step
    from worker processes; each --visualize_* writes its panel for every
    evaluated frame (the frame itself besides, and nothing else);
    --vis_pred with --eval_cub writes the keypoint panels."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.data import fixtures as FX
    args = ["--flagfile", LAPTOP, *TINY, "--checkpoint_dir", str(tmp_path),
            "--num_workers", "2"]
    if flag == "loader_processes":
        trainer = entry(_TRAIN)(parse_args(
            args + ["--loader_processes", "--total_iters", "1",
                    "--batch_log_interval", "1"]))
        trainer.train()
        assert trainer.state.step == 1
        assert all(np.isfinite(v) for v in trainer.logged[0][1].values())
        return
    vis = tmp_path / "vis"
    args += ["--vis_pred", "--eval", "--batch_size", "2", "--repeat", "1",
             "--ransac_iters", "8", "--pose_fit_max_points", "512",
             "--vis_path", str(vis)]
    if flag == "vis_pred":
        root = str(tmp_path / "cub" / "cub")
        lst = FX.cub_tree(root, per_class=2, split="test")
        cfg = parse_args(args + ["--flagfile", os.path.join(
            ROOT, "config/cub/cub.txt"), *TINY[2:], "--eval_cub",
            "--test_dataset_path", root, "--test_list", lst,
            "--dframe_eval", "1", "--batch_size", "4"])
        results = entry(_EVAL)(cfg.replace(train=False)).test()
        assert np.isfinite(results["mIoU"])
        names = os.listdir(vis)
        for suffix in ("_1.png", "_2.png", "_2_gt.png"):
            assert sum(n.endswith(suffix) for n in names) == 2, names
        return
    cfg = parse_args(args + [f"--{flag}", "--eval_nocs", "--dframe_eval",
                             "10"])
    entry(_EVAL)(cfg.replace(train=False)).test()
    names = sorted(os.listdir(vis))
    want = ("_img.png",) + PANELS[flag[len("visualize_"):]]
    if flag == "visualize_gt" and importlib.util.find_spec("matplotlib"):
        want += ("_3d.png",)
    assert names == sorted(f"{t}{x}" for t in ("000_000", "001_000")
                           for x in want)


@pytest.mark.parametrize("flagfile", sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "config", "*", "*.txt"))))
def test_config_flag_files_ask_for_nothing_unported(flagfile, capsys):
    """Every flag of every flag file is a field the port runs: none is
    ignored as unknown."""
    from selfcorr_tpu_torch.configs import Config, parse_args
    cfg = parse_args(["--flagfile", os.path.join(ROOT, flagfile)])
    assert isinstance(cfg, Config)
    assert "ignoring unknown flag" not in capsys.readouterr().out


def test_defaults_and_ported_panels_still_construct(tmp_path, capsys):
    """The defaults with --vis_pred --visualize_{mask,tex,depth} (the
    predict path's panels) build a Trainer and a Tester on the CPU; the
    Trainer logs images every --vis_freq steps, and no longer says that it
    does not."""
    from selfcorr_tpu_torch.configs import parse_args
    cfg = parse_args(["--flagfile", LAPTOP, *TINY, "--vis_pred",
                      "--visualize_mask", "--visualize_tex",
                      "--visualize_depth", "--checkpoint_dir",
                      str(tmp_path)])
    trainer = entry(_TRAIN)(cfg)
    assert trainer.state.step == 0 and trainer.cfg.vis_freq == 1000
    assert "logs no images" not in capsys.readouterr().out
    tester = entry(_EVAL)(cfg.replace(train=False))
    assert tester.device.type == "cpu"


@pytest.mark.parametrize("flagfile,cls", [
    (f, c) for f in ("config/nocs/laptop.txt", "config/cub/cub.txt")
    for c in (_TRAIN, _EVAL)])
def test_nocs_and_cub_flag_files_construct_on_fixtures(flagfile, cls,
                                                       tmp_path):
    """The NOCS and CUB flag files build a Trainer and a Tester on the CPU
    over the port's fixture trees."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.data import fixtures as FX
    root = str(tmp_path / "data")
    if "nocs" in flagfile:
        lst = FX.nocs_tree(root)
    else:
        lst = FX.cub_tree(root, split="train" if cls == _TRAIN else "test")
    cfg = parse_args(["--flagfile", os.path.join(ROOT, flagfile),
                      *TINY[2:], "--checkpoint_dir", str(tmp_path),
                      "--dataset_path", root, "--train_list", lst,
                      "--test_dataset_path", root, "--test_list", lst])
    obj = entry(cls)(cfg if cls == _TRAIN else cfg.replace(train=False))
    from selfcorr_tpu_torch.eval.tester import make_test_dataset
    from selfcorr_tpu_torch.train.loop import make_train_dataset
    make = make_train_dataset if cls == _TRAIN else make_test_dataset
    assert type(make(obj.cfg)).__name__ == {
        ("nocs", _TRAIN): "NOCSTrain", ("nocs", _EVAL): "NOCSTest",
        ("cub", _TRAIN): "CUBTrain", ("cub", _EVAL): "CUBTest"}[
        (obj.cfg.dataset_name, cls)]


def test_dino_bf16_logs_images_from_an_f32_copy(tmp_path, monkeypatch):
    """--dino_bf16: the Trainer's trunk is bfloat16 at rest; the image log
    runs forward_vis on an f32 copy of it (the JAX package applies the bf16
    weights to f32 images), whose weights are the bf16 values, and leaves
    the run's trunk in bf16. (tests/test_torch_checkpoint.py trains and
    resumes with the flag.)"""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.data import synthetic_device as SD
    from selfcorr_tpu_torch.data.synthetic import SyntheticVideos
    from selfcorr_tpu_torch.train import loop
    seen, images = [], []
    forward_vis = loop.forward_vis

    def spy(model, dino, *a, **k):
        seen.append(dino)
        return forward_vis(model, dino, *a, **k)
    monkeypatch.setattr(loop, "forward_vis", spy)

    class Images:
        def add_image(self, tag, img, step, **kw):
            images.append(tag)
    cfg = parse_args(["--flagfile", LAPTOP, *TINY, "--checkpoint_dir",
                      str(tmp_path), "--dino_bf16", "--subdivide", "1"])
    trainer = entry(_TRAIN)(cfg)
    assert trainer.state.dino.dtype == torch.bfloat16
    batch = SD.make_device_synth(cfg, SyntheticVideos(seed=0), "cpu")(
        SD.step_generator(0, 0))
    trainer._log_images(Images(), batch, 1)
    assert len(images) == 20
    assert len(seen) == 1 and seen[0].dtype == torch.float32
    assert trainer.state.dino.dtype == torch.bfloat16
    ref = trainer.state.dino.state_dict()
    assert all(torch.equal(v, ref[k].float())
               for k, v in seen[0].state_dict().items())
