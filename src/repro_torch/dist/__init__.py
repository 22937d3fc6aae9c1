"""The distributed runtime of the port (counterpart of ``repro.dist``): the
k-means mesh over ``torch.distributed`` ranks (``sharding``), the checked
hierarchical centroid reduce with its int8 hop (``reduce``,
``compression``) and the data-parallel, problem-parallel and elastic fit
(``kmeans_dist.DistributedKMeans``); the LM-side sharding on
``torch.distributed.tensor`` (``sharding``'s LM half, with
``repro_torch.launch.mesh``)."""
from repro_torch.dist import reduce, sharding
from repro_torch.dist.reduce import ReducePlan
from repro_torch.dist.sharding import mesh2d

__all__ = ["sharding", "reduce", "ReducePlan", "mesh2d"]
