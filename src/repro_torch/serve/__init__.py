"""Online serving layer of the port (counterpart of ``repro.serve``):
bucketed predict cells (:class:`ServeCompiler`, one CUDA graph per row
bucket on the card), dynamic micro-batching (:class:`MicroBatcher`, which
the LM launcher rides too) and versioned centroid hot-swap
(:class:`CodebookStore`). :class:`KMeansService` assembles them behind
``KMeans.to_service()``; ``plan_ladder`` picks the bucket ladder and window
from the H100 tile model (serve kind)."""
from repro_torch.serve.batcher import MicroBatcher, Ticket
from repro_torch.serve.compiler import DEFAULT_BUCKETS, ServeCompiler
from repro_torch.serve.service import KMeansService, ServeResult
from repro_torch.serve.store import Codebook, CodebookStore
from repro_torch.serve.tuning import ServePlan, plan_ladder

__all__ = [
    "Codebook", "CodebookStore", "DEFAULT_BUCKETS", "KMeansService",
    "MicroBatcher", "ServeCompiler", "ServePlan", "ServeResult", "Ticket",
    "plan_ladder",
]
