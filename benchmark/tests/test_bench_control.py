"""The control and the planted training fault on the card, at the cells'
own sizes, on one seed each: the reference in TF32 (the nearest precision
below the configurations' float32) fails one of each cell's numbers, and
the reference stepping on half of its batch fails one of the training
cells'. They skip without a card. `python3 benchmark/control.py` reads
the same numbers over several seeds."""
from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.harness.cell import resolve


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cells' sizes exist "
                    "only there")
    return torch.device("cuda", 0)


def _fails(cell, numbers):
    over = {k: v for k, v in numbers.items()
            if k in cell.limits and v > cell.limits[k]}
    assert over, (numbers, cell.limits)


@pytest.mark.parametrize("workload", ["laptop_train", "laptop_predict",
                                      "bottle_train"])
def test_tf32_control_fails(cuda, workload):
    cell = resolve(workload)
    _fails(cell, control.numbers(cell, 7, ["tf32"], cuda)["tf32"])


@pytest.mark.parametrize("workload", ["laptop_train", "bottle_train"])
def test_half_batch_fault_fails(cuda, workload):
    cell = resolve(workload)
    _fails(cell,
           control.numbers(cell, 7, ["half_batch"], cuda)["half_batch"])
