"""Host-clock ms per Lloyd iteration of seven fits, from whichever
``repro_torch`` the path gives, to compare two trees of the port on one
card (run each tree in turns, parent and change):

    PYTHONPATH=A/src python A/src/repro_torch/launch/fit_times.py
    PYTHONPATH=B/src python A/src/repro_torch/launch/fit_times.py

At M = 2**20, F = 128, K = 1000 (``make_blobs``, seed 0; centroids drawn
from the rows by a seeded permutation), 10 iterations at tol 0: bf16
``fused``, bf16 ``lloyd_ft`` (``FaultPolicy.correct()``), bf16 ``detect``,
int8, and f32 ``lloyd_pruned`` on the rows sorted by generating label
(seeded by each label's first row); at the PQ shape (48 problems of
``make_blobs(65_536, 16, 256, seed=i)``, the first 256 rows as
centroids), 25 iterations: ``BatchedKMeans`` at f32 and bf16. Each fit
runs once to warm up, then three times, a synchronise around each.
Prints one JSON object: fit -> three ms/iter. Needs a CUDA card.
"""
from __future__ import annotations

import json
import time


def main() -> None:
    import numpy as np
    import torch
    from repro_torch.api import FaultPolicy, KMeans
    from repro_torch.batch import BatchedKMeans
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import _build, ref
    ref.full_f32(torch.device("cuda"))
    _build.build_all()
    m, f, k = 1 << 20, 128, 1000
    x, lab = make_blobs(m, f, k, seed=0)
    x, lab = torch.from_numpy(x).cuda(), torch.from_numpy(lab).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    c0 = x[torch.randperm(m, generator=gen, device="cuda")[:k]].clone()
    order = torch.argsort(lab, stable=True)
    xs = x[order].contiguous()
    first = torch.searchsorted(lab[order], torch.arange(
        k, device="cuda", dtype=lab.dtype))
    c_sorted = xs[first].clone()
    xq = torch.from_numpy(np.stack([make_blobs(65_536, 16, 256, seed=i)[0]
                                    for i in range(48)])).cuda()
    seeds = xq[:, :256].clone()
    base = dict(n_clusters=k, max_iter=10, tol=0.0, random_state=0)
    pq = dict(n_clusters=256, max_iter=25, tol=0.0, random_state=0)
    fits = {
        "bf16_fused": lambda: KMeans(compute_dtype="bfloat16", **base)
        .fit(x, centroids=c0),
        "bf16_lloyd_ft": lambda: KMeans(
            fault=FaultPolicy.correct(), compute_dtype="bfloat16", **base)
        .fit(x, centroids=c0),
        "bf16_detect": lambda: KMeans(
            fault=FaultPolicy.detect(), compute_dtype="bfloat16", **base)
        .fit(x, centroids=c0),
        "int8": lambda: KMeans(compute_dtype="int8", **base)
        .fit(x, centroids=c0),
        "f32_pruned_sorted": lambda: KMeans(backend="lloyd_pruned", **base)
        .fit(xs, centroids=c_sorted),
        "f32_batched": lambda: BatchedKMeans(**pq).fit(xq, centroids=seeds),
        "bf16_batched": lambda: BatchedKMeans(compute_dtype="bfloat16", **pq)
        .fit(xq, centroids=seeds),
    }
    out = {}
    for name, fn in fits.items():
        fn()
        out[name] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km = fn()
            torch.cuda.synchronize()
            iters = float(np.max(np.atleast_1d(km.n_iter_)))
            out[name].append(1e3 * (time.perf_counter() - t0) / iters)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
