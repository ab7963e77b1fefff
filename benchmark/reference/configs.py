"""The reference's configuration: a frozen copy of the port's Config
dataclass, every field of it, built from a configuration file's flags
(benchmark/configs/<name>.json). dino_attn_bf16 selects the trunk's bf16
attention roundings, dino_bf16 a bf16 trunk.
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
