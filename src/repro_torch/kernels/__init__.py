"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers (``ops``)
and their plain PyTorch versions (``ref``).  Kernels build at first use."""

from . import ops, ref

__all__ = ["ops", "ref"]
