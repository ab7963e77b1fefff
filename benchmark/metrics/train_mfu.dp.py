"""train_mfu.dp: train_mfu (train_mfu.py) in the data-parallel cells, per
card on rank 0: the least time of the matrix work of one rank's step (its
shard's reference step, counted from shapes) over rank 0's window seconds
a step."""
from benchmark.harness.cell import metric_reader

read = metric_reader("train_mfu").read
