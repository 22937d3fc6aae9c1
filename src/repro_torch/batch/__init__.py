"""Many-problem K-means over the port's batched one-pass kernel."""
from repro_torch.batch.estimator import BatchedKMeans

__all__ = ["BatchedKMeans"]
