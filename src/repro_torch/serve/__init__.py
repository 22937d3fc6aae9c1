"""Serving layer of the port: the dynamic micro-batcher. The reference's
k-means service (``compiler``, ``store``, ``service``, ``tuning``) and
``KMeans.to_service`` are not ported yet."""
from repro_torch.serve.batcher import MicroBatcher, Ticket

__all__ = ["MicroBatcher", "Ticket"]
