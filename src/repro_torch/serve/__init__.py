"""Serving layer of the port: the dynamic micro-batcher. The reference's
k-means service (``compiler``, ``store``, ``service``, ``tuning``) is a
later slice (ROADMAP Queue 1 item 8)."""
from repro_torch.serve.batcher import MicroBatcher, Ticket

__all__ = ["MicroBatcher", "Ticket"]
