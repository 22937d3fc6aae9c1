"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the padding layer around them (``ops``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
