"""Configuration: a frozen dataclass plus a parser for the reference's flag
names and `--flagfile` includes (counterpart of selfcorr_tpu/configs.py).

The port keeps every field of the JAX package's Config so that any flag file
either package accepts parses here too, and runs every flag the JAX
package's Trainer and Tester read, apart from those that only steer the JAX
package, which are parsed and ignored: use_pallas, dino_flash,
dino_pad_once, platform, host_rss_restart_gb. dino_attn_bf16 selects the
trunk's bf16 attention (kernel B3 on the card), dino_bf16 a bf16 trunk.
`device` is the port's own field: entry points run on "cuda" unless the
caller asks for "cpu". A set of device and process flags that does not hold
together raises at the entry points (check_parallel_flags).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Config:
    # data
    category: str = "laptop"
    dataset_name: str = "Wild6D"          # Wild6D | nocs | cub | synthetic
    dataset_path: str = ""
    train_list: str = ""
    test_dataset_path: str = ""
    test_list: str = ""
    img_size: int = 256
    use_depth: bool = False
    use_occ: bool = False
    no_stretch: bool = False
    dataset_cache_path: str = ""

    # schedule / batch
    total_iters: int = 20000
    batch_size: int = 8
    repeat: int = 4
    learning_rate: float = 1e-4
    seed: int = 0

    # model
    depth_offset: float = 10.0
    codedim: int = 64
    n_corr_feat: int = 64
    corr_h: int = 64
    corr_w: int = 64
    subdivide: int = 3
    symmetry_idx: int = -1
    init_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    shape_prior: bool = False
    shape_prior_path: str = ""
    prior_deform: bool = False
    no_deform: bool = False
    deform_ratio: float = 1.0
    use_scale: bool = False
    rotation_offset: Tuple[float, ...] = (0.0,) * 6
    base_rot: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)
    num_multipose_az: int = 1
    num_multipose_el: int = 1
    surface_texture: bool = False
    n_tex_sample: int = 6

    # correspondence
    tau_img: float = 10.0
    tau_mesh: float = 10.0
    divide_fn: str = "frame"
    pretrain_k: int = 100

    # loss weights (parsed; the training slice consumes them)
    mask_wt: float = 0.1
    tex_wt: float = 0.05
    depth_wt: float = 0.05
    match_wt: float = 0.01
    imatch_wt: float = 0.02
    triangle_wt: float = 0.001
    pullfar_wt: float = 0.001
    deform_wt: float = 0.05
    symmetry_wt: float = 1.0
    camera_wt: float = 0.005
    cycle_loss_wt: float = 0.2
    cycle_loss_pretrain_wt: float = 0.05
    decay_ratio: float = 1.0
    flatten_loss: bool = False
    camera_loss: bool = False
    depth_loss_chamfer: bool = False

    # optimizer
    vert_lr_ratio: float = 0.1
    cam_lr_ratio: float = 0.1

    # pretrained bootstrap
    resnet_init_path: str = ""
    dino_init_path: str = ""
    warm_start_path: str = ""

    # infra
    train: bool = True
    test: bool = False
    checkpoint_dir: str = "log"
    name: str = "exp"
    model_path: str = ""
    save_freq: int = 2000
    vis_freq: int = 1000
    batch_log_interval: int = 10
    num_workers: int = 8
    loader_processes: bool = False
    logger: str = "tensorboard"

    # eval
    dframe_eval: int = 10
    eval: bool = False
    eval_nocs: bool = False
    eval_cub: bool = False
    shuffle_test: bool = False
    vis_path: str = ""
    vis_pred: bool = False
    visualize_mesh: bool = False
    visualize_conf: bool = False
    visualize_match: bool = False
    visualize_imatch: bool = False
    visualize_gt: bool = False
    visualize_bbox: bool = False
    visualize_depth: bool = False
    visualize_tex: bool = False
    visualize_mask: bool = False
    match_with_bbox: bool = False

    # JAX-package switches, accepted for flag-file compatibility
    compact_transfer: bool = True
    synthetic_shape: str = "ellipsoid"
    synthetic_on_device: bool = False
    steps_per_dispatch: int = 1
    platform: str = ""
    num_devices: int = 1
    multihost: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    profile_steps: int = 0
    host_rss_restart_gb: float = 90.0
    symmetry_npts: int = 10000
    ransac_iters: int = 100
    pose_fit_max_points: int = 16384
    use_pallas: bool = True
    dino_flash: bool = True
    dino_pad_once: bool = True
    dino_attn_bf16: bool = True
    dino_bf16: bool = False

    # port only: the torch device entry points run on ("cuda" | "cpu")
    device: str = "cuda"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_MULTI_PROCESS = ("coordinator_address", "num_processes", "process_id")


def check_parallel_flags(cfg: Config) -> None:
    """Raise ValueError if the device and process flags do not hold
    together (parallel.layout reads them): --num_devices N is the global
    device count, at least 1; --coordinator_address, --num_processes P and
    --process_id i come all three or none, with 0 <= i < P and N a multiple
    of P (each process starts N / P ranks)."""
    if cfg.num_devices < 1:
        raise ValueError(f"--num_devices {cfg.num_devices}: the global "
                         f"device count is at least 1")
    given = {"coordinator_address": cfg.coordinator_address != "",
             "num_processes": cfg.num_processes > 0,
             "process_id": cfg.process_id >= 0}
    if any(given.values()) and not all(given.values()):
        raise ValueError(
            f"the multi-process flags come together: "
            f"{', '.join('--' + n for n in _MULTI_PROCESS)}; missing "
            f"{', '.join('--' + n for n, v in given.items() if not v)}")
    if not cfg.num_processes:
        return
    if not cfg.process_id < cfg.num_processes:
        raise ValueError(f"--process_id {cfg.process_id} out of range for "
                         f"--num_processes {cfg.num_processes}")
    if cfg.num_devices % cfg.num_processes:
        raise ValueError(
            f"--num_devices {cfg.num_devices} (the global device count) is "
            f"not a multiple of --num_processes {cfg.num_processes}: every "
            f"process starts as many ranks")


_TUPLE_FIELDS = {"init_scale": 3, "rotation_offset": 6, "base_rot": 9}
_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}
_IGNORED_FLAGS = {"ngpu", "local_rank", "topk_img", "topk_mesh", "nz_feat",
                  "feat_shape", "n_faces"}


def _parse_value(name: str, raw: str):
    if name in _TUPLE_FIELDS:
        parts = [p for p in raw.replace("[", "").replace("]", "").split(",")
                 if p]
        return tuple(float(p) for p in parts)
    t = _FIELD_TYPES[name]
    if t in ("bool", bool):
        return raw.lower() in ("true", "1", "yes", "")
    if t in ("int", int):
        return int(raw)
    if t in ("float", float):
        return float(raw)
    return raw


def parse_args(argv, base: Config | None = None) -> Config:
    """Parse '--flag=value' / '--flag value' / '--flag' / '--noflag'
    arguments, expanding --flagfile includes in place. Unknown flags are
    ignored with a warning."""
    cfg = dataclasses.asdict(base or Config())
    tokens = list(argv)
    i = 0
    valid = set(_FIELD_TYPES)
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if not tok.startswith("--"):
            continue
        body = tok[2:]
        if "=" in body:
            name, raw = body.split("=", 1)
        else:
            name = body
            if i < len(tokens) and not tokens[i].startswith("--"):
                raw = tokens[i]
                i += 1
            else:
                raw = ""
        if name == "flagfile":
            with open(raw) as f:
                sub = [ln.strip() for ln in f
                       if ln.strip() and not ln.strip().startswith("#")]
            tokens[i:i] = sub
            continue
        neg = False
        if name.startswith("no") and name[2:] in valid and name not in valid:
            name = name[2:]
            neg = True
        if name in _IGNORED_FLAGS:
            continue
        if name not in valid:
            print(f"[config] ignoring unknown flag --{name}")
            continue
        cfg[name] = False if neg else _parse_value(name, raw)
    return Config(**cfg)
