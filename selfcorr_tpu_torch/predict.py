"""Inference / evaluation entry point of the port.

  python -m selfcorr_tpu_torch.predict --flagfile config/wild6d/laptop.txt \
      --dataset_name synthetic --eval --eval_nocs --batch_size 16 \
      --repeat 1 --dframe_eval 1 [--vis_pred] [--device cpu] \
      [--model_path log/exp/ckpt | --model_path pred_net_20000.pth] \
      [--num_devices N [--num_processes P --process_id i \
       --coordinator_address host:port | --multihost]]

Runs on CUDA unless --device cpu is given; a missing GPU is an error.
--model_path takes a port checkpoint (a run's ckpt directory, its latest
step, or one step's directory) or a reference pred_net_*.pth; without it
the weights are initialized from --seed. Several devices split each batch
of --batch_size rows between their ranks (eval/tester.py, parallel/).
"""
from __future__ import annotations

import sys

import numpy as np


def _test(rank, cfg) -> dict:
    from selfcorr_tpu_torch.eval.tester import Tester
    from selfcorr_tpu_torch.utils.device import set_fp32_precision
    set_fp32_precision()
    np.random.seed(cfg.seed)
    return Tester(cfg, rank=rank).test()


def main(argv) -> dict | None:
    """argv[0] is the program name, as in sys.argv. Returns the metrics
    when the evaluation ran in this process, None when it ran in spawned
    local ranks (rank 0 prints them)."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.parallel import launch
    from selfcorr_tpu_torch.utils.device import resolve_device
    cfg = parse_args(argv[1:]).replace(train=False)
    resolve_device(cfg.device)
    return launch(_test, cfg, cfg)


if __name__ == "__main__":
    main(sys.argv)
