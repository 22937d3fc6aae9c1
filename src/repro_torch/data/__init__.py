from repro_torch.data.blobs import make_blobs
from repro_torch.data.synthetic import TokenPipeline

__all__ = ["make_blobs", "TokenPipeline"]
