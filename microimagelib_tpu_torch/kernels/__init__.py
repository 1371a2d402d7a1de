"""Loaders and wrappers of the port's hand-written CUDA kernels
(sources in ``csrc/``). Importing builds nothing; the first launch does."""
