"""Algorithm numerics of the port: seeding, updates, DMR, ABFT checksums and
thresholds, fault injection, the offline ABFT product (``ft_gemm``) and the
assignment backends."""
from repro_torch.core.fault import FaultConfig
from repro_torch.core.ft_gemm import abft_dot, ft_matmul

__all__ = ["FaultConfig", "ft_matmul", "abft_dot"]
