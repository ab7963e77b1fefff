"""device_idle_pct.dp: device_idle_pct.train (device_idle_pct.train.py) in
the data-parallel cells: the share of rank 0's traced window of steps in
which no operation ran on its card."""
from benchmark.harness.cell import metric_reader

read = metric_reader("device_idle_pct.train").read
