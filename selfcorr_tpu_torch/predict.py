"""Inference / evaluation entry point of the port.

  python -m selfcorr_tpu_torch.predict --flagfile config/wild6d/laptop.txt \
      --dataset_name synthetic --eval --eval_nocs --batch_size 16 \
      --repeat 1 --dframe_eval 1 [--vis_pred] [--device cpu]

Runs on CUDA unless --device cpu is given; a missing GPU is an error. With
no --model_path the weights are initialized from --seed; checkpoint import
comes in a later slice.
"""
from __future__ import annotations

import sys

import numpy as np


def main(argv) -> dict:
    """argv[0] is the program name, as in sys.argv."""
    from selfcorr_tpu_torch.configs import parse_args
    from selfcorr_tpu_torch.utils.device import (resolve_device,
                                                 set_fp32_precision)
    cfg = parse_args(argv[1:]).replace(train=False)
    resolve_device(cfg.device)
    set_fp32_precision()
    np.random.seed(cfg.seed)

    from selfcorr_tpu_torch.eval.tester import Tester
    return Tester(cfg).test()


if __name__ == "__main__":
    main(sys.argv)
