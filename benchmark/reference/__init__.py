"""Frozen plain copy of the program's model code: the benchmark's reference.

No kernel, no build, nothing of the program: each module is a copy of its
counterpart in the port with every kernel route replaced by the plain
PyTorch version the port keeps beside it. It decides `correct`, so it
stays as it is while the program changes.
"""
