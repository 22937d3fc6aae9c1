"""Bucketed predict cells, one CUDA graph per row bucket (counterpart of
``repro.serve.compiler``).

Online predict traffic comes in any row count, while a launch pays its host
cost (argument checks, padding, a handful of kernel launches) every time.
Requests are padded up to a short ladder of row-count buckets, and each
bucket's predict cell is built before the service takes traffic: on a CUDA
device a ``torch.cuda.CUDAGraph`` captured once, after a warm-up run that
builds the kernels (``nvcc``) and sets their attributes, around static
input and output buffers. Serving a bucket is then one copy of the request
(zero-padded) and of the pinned codebook's centroids into the cell's inputs,
one graph replay and a copy of each output. Centroid padding, their norms
and the f32 kernels' pre-pass run inside the graph, so a hot-swapped
codebook flows into the same graph: the compiler's ``captures`` stays at the
bucket count for the life of the service (the port's counterpart of the
reference's zero-compile invariant). A capture that fails raises; nothing
falls back to eager launches on the card. On the CPU a cell is the same
backend call at the bucket's shapes, eager (the tests' path).
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import distance_argmin_ft as _daft
from repro_torch.kernels import ops

# Default row-count ladder: geometric with ratio 4, so padding wastes at
# most 4x rows while the cells stay few. ``repro_torch.serve.tuning.
# plan_ladder`` tunes it per model shape.
DEFAULT_BUCKETS: tuple[int, ...] = (128, 512, 2048)


class _Cell:
    """One bucket's predict cell: static inputs ``x`` (bucket, F) and ``c``
    (K, F) in f32 on the device, the outputs of the backend call on them,
    and on a CUDA device the graph that recomputes those outputs in
    place."""

    def __init__(self, compiler: "ServeCompiler", bucket: int) -> None:
        dev = compiler.device
        self.bucket = bucket
        self.x = torch.zeros((bucket, compiler.n_features),
                             dtype=torch.float32, device=dev)
        self.c = torch.zeros((compiler.n_clusters, compiler.n_features),
                             dtype=torch.float32, device=dev)
        backend, params = compiler.backend, compiler.bucket_params(bucket)
        cast = compiler.kernel_dtype
        # a descriptor on the device, made before any capture: the FT
        # entry's .to(device) is then a no-op, never a host copy in a graph
        inj = _daft.no_injection().to(dev) if backend.takes_injection \
            else None
        kw = {} if params is None else {"params": params}
        if inj is not None:
            kw["inj"] = inj

        def run() -> tuple:
            return tuple(backend(self.x.to(cast), self.c.to(cast), **kw))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        if dev.type != "cuda":
            self.run = run
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()                    # builds the kernels, sets attributes
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run()
        compiler.captures += 1

    def __call__(self, x: Any, centroids: torch.Tensor) -> tuple:
        """(assign, sq-dist, detected) of the first ``len(x)`` rows, copies
        that outlive the next call."""
        m = x.shape[0]
        self.x[:m].copy_(torch.as_tensor(x))
        if m < self.bucket:
            self.x[m:].zero_()
        self.c.copy_(centroids)
        if self.graph is None:
            am, md, det = self.run()[:3]
            return am[:m], md[:m], det
        self.graph.replay()
        am, md, det = self.out[:3]
        return am[:m].clone(), md[:m].clone(), det.clone()


class ServeCompiler:
    """Predict cells for one model shape, built at construction.

    ``backend`` is a registry backend (the estimator's predict backend),
    ``dtype`` the compute dtype (the cells cast the f32 request and
    centroids to it, as the estimator's predict does; int8 quantises
    inside the backend). Tiles per bucket come from ``params`` or the
    ``serve`` kind of the ``autotune`` table. ``dispatch`` routes a
    request to the smallest bucket that holds it; a request beyond the top
    bucket runs through it in chunks, each chunk's outputs copied before
    the next replay. ``captures`` counts graph captures, ``replays`` the
    graph replays of each bucket (the Python launch counters of the kernel
    wrappers see only the warm-up and capture calls)."""

    def __init__(self, backend: Any, n_clusters: int, n_features: int, *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 dtype: Any = torch.float32, autotune: Optional[Any] = None,
                 params: Optional[ops.KernelParams] = None,
                 device: Any = "cuda") -> None:
        from repro_torch.api.estimator import resolve_device
        from repro_torch.core.autotune import as_dtype
        if not buckets:
            raise ValueError("need at least one row bucket")
        sizes = tuple(sorted({int(b) for b in buckets}))
        if sizes[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.backend = backend
        self.n_clusters = int(n_clusters)
        self.n_features = int(n_features)
        self.buckets = sizes
        self.dtype = as_dtype(dtype)
        self.kernel_dtype = torch.float32 if self.dtype == torch.int8 \
            else self.dtype
        self.device = resolve_device(device)
        self._autotune = autotune
        self._params = params
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = {b: 0 for b in sizes}
        self._cells = {b: _Cell(self, b) for b in sizes}

    def bucket_params(self, bucket: int) -> Optional[ops.KernelParams]:
        """Tiles of one bucket's cell: ``params``, else the ``serve``
        kind's winner at the bucket's shape, clamped to it; None for a
        backend without tiles."""
        if not self.backend.takes_params:
            return None
        p = self._params
        if p is None:
            if self._autotune is None:
                from repro_torch.api.cache import default_cache
                cache = default_cache()
            else:
                cache = self._autotune
            _, p = cache.lookup(bucket, self.n_clusters, self.n_features,
                                kind="serve", dtype=self.dtype)
        return ops.clamp_params(bucket, self.n_clusters, self.n_features, p)

    def cell(self, bucket: int) -> _Cell:
        """The cell of one registered bucket."""
        return self._cells[bucket]

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket holding ``rows`` (the top one above it)."""
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def dispatch(self, x: Any, centroids: torch.Tensor) -> tuple:
        """Serve one (m, F) request batch (numpy or a tensor) against
        ``centroids`` (K, F) f32 on the device. Returns (assign (m,) int32,
        sq-dist (m,) f32, detected 0-d int32) on the device; m = 0 returns
        empty outputs without a launch."""
        m, f = x.shape
        if f != self.n_features:
            raise ValueError(f"request has {f} features, the cells are "
                             f"built for {self.n_features}")
        dev = self.device
        if m == 0:
            return (torch.zeros(0, dtype=torch.int32, device=dev),
                    torch.zeros(0, dtype=torch.float32, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))
        top = self.buckets[-1]
        if m > top:
            outs = [self.dispatch(x[i:i + top], centroids)
                    for i in range(0, m, top)]
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]),
                    torch.stack([o[2] for o in outs]).sum().to(torch.int32))
        bucket = self.bucket_for(m)
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x, dtype=np.float32)
        with self._lock:
            out = self._cells[bucket](x, centroids)
            if self._cells[bucket].graph is not None:
                self.replays[bucket] += 1
        return out


__all__ = ["ServeCompiler", "DEFAULT_BUCKETS"]
