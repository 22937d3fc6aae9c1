#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, on the card

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
source, in parallel) and drives the port's paths: ``repro_torch.api.KMeans``
fit/predict/score, unprotected, ABFT-protected online (``correct``) and
offline (``detect``), pruned (``backend="lloyd_pruned"``), quantised
(``compute_dtype="int8"``) and in bf16 / fp16 (``compute_dtype=
"bfloat16"/"float16"``, tensor cores), at M = 2**20 rows x F = 128 features x
K = 1000 clusters; internlm2-1.8b serving (``repro_torch.launch.serve``,
prefill + greedy decode through the micro-batcher on the flash kernel;
fp16 flash attention through ``attend``);
and ``repro_torch.batch.BatchedKMeans`` seeding, fit, predict and score at
the width of product-quantisation codebook training for an IVF-PQ index
over 768-d embeddings: B = 48 sub-quantisers of
F = 16 dimensions, K = 256 centroids (8-bit codes), N = 65,536 training rows
each (FAISS ``max_points_per_centroid`` 256 x K; FAISS's ``niter`` = 25).
Phases, one line each:

  1. device: the card, its power limit, the kernels' build time, ptxas
     lines, and each f32 tile kernel instantiation's registers, spill
     bytes and resident blocks an SM (two blocks at BM = 128); the same of
     the int8 tile kernel (s8 tensor cores) at Fp 128 and 1024, and of
     every 2-byte tile kernel instantiation at Fp 32 and 128 (FT ones also
     320), each gated at two blocks an SM; and the f32 flash kernel's at
     head dims 64, 128 and 256 and the DMR update's kernels';
  2. kernels vs their plain PyTorch versions (TF32 off) at M = 65,573,
     F = 100, K = 1000 and 100, and F = 300 (Fp = 320), K = 1000, plus
     planted FT faults; the one-pass
     steps' entries (``lloyd_step``: the tree over them) bit for bit the
     dense route (``tile_update``'s partials, then the torch tree) with a
     control (two leaves swapped) that must break the bits, and
     ``fused_lloyd`` = the two-pass update = clean ``fused_lloyd_ft``; the
     FT cases (an update fault on a present (tile, cluster) pair, on an
     absent one, in a padded cluster row, a distance fault, both) each
     with the dense route's detection count and the clean step's bits; the
     compact update (``update.compact_update``) and the tree kernel
     (``update.tree_sum``) bit for bit the dense route at 513 row tiles,
     at the kernel's labels and at labels in random order, sorted, skewed
     and all in one cluster, each with a control that must break the
     bits, and at row tiles of 64 and 320 padded features;
  3. unprotected fit (``fused``) + predict + score, and the one-pass
     ``lloyd`` fit from the same centroids;
  4. protected fit, clean and under an SEU campaign;
  5. per-kernel launches on the main path (phases 3-4), time per launch at
     the phase-3 shape, the plain version's time, the bound and a library
     yardstick (``torch.addmm`` + ``min``; ``index_add_`` for the update),
     each f32 row's share of its bound, ``lloyd_step``'s minima and labels
     bit for bit each distance's FMA chain over the features in order
     (``distance_argmin.fma_f32`` on the card, 8 row tiles against every
     centroid, then the first minimum: the witness that the FMA chains
     did not move), the compact update's per-tile pass and
     tree timed apart and together
     beside ``index_add_`` and their bounds, the tree kernel's dense
     variant on ``lloyd_step``-sized partials beside the torch tree and ``sum(0)``, ``ops.tiled_update`` with and
     without DMR (ms, peak GB), and the one-pass steps as a fit runs them
     (``fused_lloyd``, ``fused_lloyd_ft``: ms and peak GB past X; the tree
     over ``lloyd_step``'s entries, the ``tree_reduce`` row: the sparse
     variant phases 3-4 launch; the entries-form FT verification, whose
     kernel ``verify_entries`` is held to its plain version clean and on a
     planted fault, with its row);
  6. the batched one-pass step and the k-means++ round against their plain
     versions at the PQ shape, at B = 7, N = 10,007, F = 20, K = 200 (two
     centroid tiles, ragged rows and features) and K = 100 (one tile),
     batched problems against ``lloyd_step`` on each problem alone (the
     tree over the dense partials bit for bit the tree over the entries),
     and the
     tree kernel over the batched partials at the problem stride bit for
     bit the ``movedim`` route (timed beside it at the PQ shape);
  7. ``BatchedKMeans`` at the PQ shape: fused k-means++ seeding, 25 steps at
     tol = 0 held bit for bit to 48 single-problem ``lloyd`` fits from the
     same seeds, predict and score, a tol = 1e-4 fit, a ``torch.profiler``
     trace of one batched and one single-problem fit (kernels put on the
     card, device-busy share), ``lloyd_step`` on one problem alone, and the
     launches, times, bounds and yardsticks of the two batched kernels and
     of the tree kernel's dense variant over the batched partials (the
     ``tree_reduce_dense`` row: its launches are the batched fit's);
  8. the pruned one-pass step and the int8 distance kernel against their
     plain versions at phase 2's shapes: a random skip mask on integer data
     (every sum exact, so labels, every entry and the trees over them
     bitwise the plain dense route's), the all-zero mask against
     ``lloyd_step`` bitwise (minima, labels, every entry), int8 on float
     data bitwise against its
     plain version (exact integer products on both sides) at row tiles of
     128 and 64, also at F = 300 (X stashed, three chunks) and F = 1000
     (X's chunks streamed), and on quantisation-safe data against
     ``distance_argmin``;
  9. at the phase-3 shape: ``lloyd_pruned`` fits bitwise equal to ``lloyd``
     fits with rows in random order (prune fraction near 0: the
     bookkeeping's cost) and sorted by generating label from the first row
     of each label (centroid tiles aligned with row tiles: >= 50 % pruned
     in the last third); an int8 fit from phase 3's seeds whose exact
     inertia is at most 5 % above the ``fused`` fit's, one from the blob
     centres within 5 % of it, predict and score, and the exact inertia of
     int8 and ``fused`` fits from four more k-means++ seeds; the two
     kernels' rows (the pruned step at the sorted fit's third step's mask:
     its peak memory past X, the tree over its entries, the no-skip step
     beside ``lloyd_step`` on the same inputs) and the int8 kernel's share
     of its bound;
 10. ``FaultPolicy.detect()`` (offline ABFT, backend ``abft_offline``) fit,
     predict and score from phase 3's seeds at the phase-3 shape: ms/iter
     beside ``fused`` and ``lloyd_ft``, labels against the ``fused`` fit
     (>= 99.9 %), inertia (1e-4), detections and the clean product's
     checksum residual over ``ft_matmul``'s threshold; a detect campaign
     (resolves to ``lloyd_ft``, centroids bitwise its clean fit's); the ABFT
     GEMM (``ops.abft_matmul``, at f32 the split on the bf16 tensor cores)
     at the detect fit's product and at internlm2-1.8b's FFN up-projection
     (8192 x 2048 x 8192), clean and with a 5e4 fault, against its plain
     version, ``torch.matmul`` in full f32 (TF32 off) and ``ft_matmul``,
     with the kernel's own clean-residual margin (the threshold over the
     largest clean residual of any tile) and its encodings pre-pass alone;
     the f32 GEMM also at ``ABFT_TILE_CASES`` (clean, three faults, one
     under the threshold, two launches bitwise, the encodings and Y's
     planes bitwise their plain split); the DMR update
     (``centroid_update_dmr``) on the fused
     fit's labels against its plain version, a corrupted shadow partial,
     two ``index_add_`` + ``bincount`` updates and their compare (a DMR
     update's work; one update beside it) and
     ``ops.tiled_update(use_dmr=True)``; the DMR update's cases: on the
     fused fit's labels, every row in one cluster, half of them in one, a
     short last slab and labels -1 and >= K, each against its plain
     version, two launches and ``dmr_walk_plain`` (its order of adds) bit
     for bit, a fault a quarter of the threshold let through beside the
     flagged ``SHADOW_FAULT``, and the skewed cases' times;
     the two kernels' rows;
 11. the flash-attention kernel against its plain version (the f32 oracle)
     at internlm2-1.8b's prefill (B = 4, H = 16, KV = 8, S = 2048,
     hd = 128, bf16, causal) and decode (one query, a 2080-slot cache with
     cold slots; bf16 and f32) shapes, each under its bars with a control
     that must fail them, with its time, the plain version's, SDPA's and
     the bounds; the f32 kernel at the prefill shape beside f32 SDPA, its
     tile-skip share and strided views; the tensor-core kernel on a
     decode's K/V; the reference test's f32 shape, windows, ragged ends, a
     fully masked row (mean of v, or zero with ``zero_empty_rows``), head
     dims 256 and 16, strided views; the f32 kernel on shuffled, holed and
     non-monotone positions, at head dims 64 and 256, GQA groups 1, 3, 4,
     8 and 16 (the heads a block packs), Sq 17 on a cold-slot cache, and
     with masked rows inside its tiles under both ``zero_empty_rows``;
 12. ``repro_torch.launch.serve`` serving 8 requests of internlm2-1.8b at
     full width and depth (seeded weights; waves of 4, prompt 2048, 32
     generated tokens; 1536 flash launches), the first wave teacher-forced
     through the kernel and the plain attention routes (logits within 5e-2
     x max|logit|), traces of one prefill and one decode step, and an FT
     K-means codebook over the wave's 1,572,864 prefill keys under an SEU
     campaign (``examples/kv_quantize.py`` at full width);
 13. ``KMeans(compute_dtype="bfloat16"/"float16")`` on the tensor-core
     variants (``mma.sync``; the FT kernels' checksums on the tensor cores
     after the C encodings' pre-pass, ``encode_centroids``) of
     ``distance_argmin``, ``lloyd_step``, ``distance_argmin_ft`` and
     ``lloyd_step_ft``: each against its plain version at phase 2's shapes
     with phase 2's FT cases (labels equal but for near ties), and phase
     2's one-pass, compact-update and tree checks on 2-byte X (plus rows
     scaled over 23 binades, whose sums hang on the order, where the
     controls must break the bits); full-size fits from phase 3's
     seeds (``fused`` = ``lloyd`` = clean ``lloyd_ft`` = campaign bit for
     bit, predict = the labels of one more step from the final centroids,
     exact inertia and labels against the f32 fit); each variant's row at
     the phase-3 shape, the compact update's and the pre-pass's among
     them, and phase 5's one-pass step records; and the clean residual
     margins of the two FT kernels at f32, bf16 and fp16 with the
     campaign's smallest delta against the thresholds.
 14. the rest of the 2-byte variants, at bf16 and fp16: (a) the batched
     step (B = 7, N = 10,007, F = 20, K = 200 and 100; each problem's
     entries, labels and sums bit for bit ``lloyd_step`` on that problem
     alone, and the tree over all problems' entries bit for bit the dense
     route, ``tile_update`` per problem then the tree, with a perturbed
     entry as the control), the pruned step (a
     random mask on integer data, entries and trees bitwise; the all-zero
     mask bit for bit the 2-byte ``lloyd_step``, every entry) and the
     2-byte ABFT GEMM (clean, a fault over the dtype's threshold, one under it, two launches bitwise equal, its
     encodings pre-pass) against their plain versions, also at the tiles
     its kernel treats apart (``ABFT_TILE_CASES``), and the
     fp16 flash kernel at internlm2-1.8b's prefill and decode shapes under
     the fp16 bars with failing controls, through ``attend`` and the op;
     (b) ``BatchedKMeans`` at the PQ shape, 25 steps at tol = 0 bit for bit
     48 single-problem 2-byte ``lloyd`` fits from the same seeds, predict
     and score, no dense launch (entries and the sparse tree only) and the
     fit's peak memory; (c) ``lloyd_pruned`` at the phase-3 shape with rows
     sorted by label, bit for bit the 2-byte ``lloyd`` fit (prune fraction,
     ms/iter); (d) ``FaultPolicy.detect()`` from phase 3's seeds (ms/iter,
     detections, labels against the same dtype's ``fused`` fit, the exact
     inertia of its centroids at most 5 % above that fit's) and the
     2-byte ABFT GEMM at phase 10's shapes (clean, a planted fault found
     and corrected, one under the threshold let through; launches of the
     GEMM and of its encodings pre-pass);
     (e) the rows of the new kernels; the batched step's at the PQ shape
     with the entries-vs-dense control, the tree over its entries timed
     apart and the step's peak memory past X beside the dense blocks the
     entries replace; the pruned step's at the sorted fit's third step's
     mask with its peak memory past X and the no-skip step beside
     ``lloyd_step``.
 15. (a) ``KMeans(batch_size=131_072)`` fits at the phase-3 shape from
     phase 3's seeds (``fused``, ``lloyd``, ``lloyd_ft`` clean and under a
     campaign, int8, ``detect``, bf16 ``lloyd``): each step's centroids bit
     for bit a hand-driven loop of the same backend wrapper over numpy's
     batches, clean detections 0, the campaign's > 0 with the clean fit's
     centroids, ``labels_`` = ``predict(X)``, ms/iter; (b) the autotune
     table: ``measure_score`` of every candidate tile of the assign, lloyd,
     lloyd_ft, serve and init kinds at f32 and bf16 at the phase-3 shape
     and at the serve buckets, the measured and model winners (built
     tiles), the measured table saved and read back, the model keeping
     (128, 128, 32) at phases 3 / 7 / 13's shapes, the shared-memory model
     against the kernels' own bytes, and one graph replay's latency (the
     serve model's per-launch constant); (c) ``KMeans.to_service()`` of the
     fused, lloyd_ft and a bf16 model at ``DEFAULT_BUCKETS`` and at
     ``plan_ladder``'s ladder, one CUDA graph a bucket: requests of 0, 1,
     127, 128, 129, 2048 and 5000 rows bit for bit ``predict`` with no
     eager launch, a stream of 1000 requests with three publishes (one
     mid-flight from the ``on_dispatch`` hook) and a refine, each answer
     bit for bit the predict of its codebook version, captures unchanged,
     the state's round trip; each bucket's replay beside eager predict,
     requests/s of the started micro-batcher beside one predict a
     request, and the card's idle share over the stream. Phase 15's
     launches (graph replays times each cell's kernels) are added to the
     rows of the kernels line.

A kernel's bound counts the work of the function at the true M, K and F,
not at the padded tile grid; the padded figures are printed beside it.

Any failed check exits non-zero. Imports nothing of JAX or the reference
package. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
M_FULL, F_FULL, K_FULL = 1_048_576, 128, 1000
M_SMALL, F_SMALL = 65_573, 100
F_WIDE = 300                    # phase 2's third shape: Fp = 320
F_INT8_WIDE = 1000              # phase 8: the int8 kernel with X streamed
ITERS = 10
SEED = 0
B_PQ, N_PQ, F_PQ, K_PQ = 48, 65_536, 16, 256
PQ_ITERS = 25
INT8_INERTIA_RTOL = 0.05   # the reference's bar, tests/test_int8.py
INT8_SWEEP_SEEDS = (1, 2, 3, 4)   # more k-means++ seeds for phase 9 (c)
# phase 10: the reference's bar for a fit against the fused fit
# (tests/test_kmeans.py), and the inertia of the detect fit against it
DETECT_LABEL_AGREEMENT = 0.999
DETECT_INERTIA_RTOL = 1e-4
# phase 10's LM product: internlm2-1.8b's FFN up-projection
# (src/repro/configs/internlm2_1_8b.py: d_model 2048, d_ff 8192), 4 x 2048
# tokens
LM_TOKENS, LM_D_MODEL, LM_D_FF = 4 * 2048, 2048, 8192
# the DMR update's debug fault: (slab, cluster, feature, delta), an
# exponent-bit-flip-sized delta (the campaigns' 2^18..2^23 range)
SHADOW_FAULT = (0, 3, 5, 2.0 ** 20)
# phases 11-12: internlm2-1.8b serving (src/repro/configs/internlm2_1_8b.py:
# 24 layers, d_model 2048, 16 query heads, 8 KV heads, head dim 128), full
# width and depth, seeded random weights; 8 requests in waves of 4, prompt
# 2048, 32 generated tokens
LM_ARCH = "internlm2-1.8b"
LM_SMOKE = False                # full width and depth
DEV = "cuda"                    # phases 11-12 run on the card
LM_BATCH, LM_HEADS, LM_KV_HEADS, LM_HD = 4, 16, 8, 128
LM_PROMPT, LM_GEN, LM_REQUESTS = 2048, 32, 8
NEG_POS = -(1 << 30)            # an empty cache slot (models.attention)
# phase 11, the kernel against the f32 oracle: |err| <= atol + rtol |want|
# under every bar of its dtype. The reference test's bars
# (tests/test_kernels_extra.py): f32 (2e-6, 1e-3), bf16 (2e-2, 1e-3). The
# reference's bf16 bar is 2/3 of a decode output (~0.03), so every bf16
# check also holds one bf16 ulp at 1 (2^-8), absolute and relative (p is
# rounded to bf16 before P V: up to ~2e-3 on short rows at prefill), and
# the decode shape, which averages over 2049 keys, a quarter of that in
# absolute terms. A control that must fail each bar, a kernel that lets
# the cold slots in (or, at prefill, sees one key past the causal edge),
# shows the bar would catch it.
FLASH_F32_BARS = ((2e-6, 1e-3),)
FLASH_BF16_BARS = ((2e-2, 1e-3), (2.0 ** -8, 2.0 ** -8))
FLASH_DECODE_BARS = FLASH_BF16_BARS + ((2.0 ** -10, 2.0 ** -8),)
# teacher-forced logits, kernel route vs plain route: a bf16 bar through
# 24 layers, x max|logit|
LM_LOGIT_RTOL = 5e-2
KV_CODEBOOK = 64                # examples/kv_quantize.py's codebook
# phase 13, the bf16 / fp16 variants: a kernel label may differ from its
# plain version's only on a near tie (the two best plain distances within
# 2^-20 of the larger's magnitude), on at most 0.01 % of the rows; a fit's
# exact f32 inertia within 2 % of the f32 fused fit's and its labels >= 98 %
# equal to them (the reference's bars, tests/test_templates.py:274-280)
LOWP_TIE_RTOL = 2.0 ** -20
LOWP_TIE_SHARE = 1e-4
LOWP_INERTIA_RTOL = 0.02
LOWP_LABEL_AGREEMENT = 0.98
# the campaign's smallest delta (core/fault.py: 2^18..2^23, either sign)
CAMPAIGN_MIN_DELTA = 2.0 ** 18
# phase 14: fp16 flash against the f32 oracle under the reference test's
# bf16 bar scaled by fp16's eps (2^-10 against 2^-7: atol 2e-2 -> 2.5e-3);
# decode also under a quarter of one fp16 ulp at 1, as the bf16 decode bar
FLASH_FP16_BARS = ((2.5e-3, 1e-3),)
FLASH_FP16_DECODE_BARS = FLASH_FP16_BARS + ((2.0 ** -12, 2.0 ** -10),)
# a planted ABFT GEMM fault is this many times the threshold of its tile
# (rounded up to a power of two), so it must be found at every dtype; the
# corrected element then holds to f32 rounding at the fault's magnitude
# (each package subtracts its own f32 checksum residual): 2^-16 |delta| at
# 2 bytes; at f32 the threshold is that tight rounding's own, and the
# corrected element holds to the tile's clean residual, under its threshold
ABFT_FAULT_OVER_THRESHOLD = 8.0
ABFT_FIX_RTOL = 2.0 ** -16
# phases 10 (f32) and 14 (bf16, fp16): the ABFT GEMM at the tiles its
# kernel treats apart, each on a ragged (m, k, n): one warpgroup a tile
# under 64 rows with a 32-deep k-step (8, 40 rows; Kp not a multiple of the
# 64-deep stage), an odd number of D bands a warp (24 rows: one in warp 1)
# over ~15 jobs a block on the two-band staging (Kp 64), several sub-tiles
# a tile with a 512-deep k-step (256 x 256), the largest tile
# phase 15: mini-batch fits of 131,072 rows a step (~131 a centroid at K =
# 1000, inside FAISS's 39 K - 256 K training rows), 10 steps; serving at
# the port's DEFAULT_BUCKETS, requests of no row, one, a bucket less, at and
# past one, and past the top one; a stream of 1000 requests of
# log-uniform size 1-8192 from seed 0, eight submitting threads
MB_BATCH, MB_ITERS = 131_072, 10
SERVE_BUCKETS = (128, 512, 2048)
SERVE_SIZES = (0, 1, 127, 128, 129, 2048, 5000)
STREAM_REQUESTS, STREAM_MAX_ROWS, STREAM_THREADS = 1000, 8192, 8
ABFT_TILE_CASES = (((8, 128, 32), (1000, 96, 300)),
                   ((40, 128, 32), (1000, 160, 500)),
                   ((24, 128, 32), (3000, 64, 4000)),
                   ((256, 256, 512), (1500, 1100, 700)),
                   ((1024, 1024, 128), (3000, 300, 2500)))


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def blob_centers(k: int, f: int, seed: int):
    """The centres ``make_blobs(.., k, seed=seed)`` draws its blobs around."""
    import numpy as np
    return (np.random.default_rng(seed).normal(size=(k, f)) * 10.0
            ).astype(np.float32)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` over ``reps`` launches queued behind a
    sleep kernel that outlasts their enqueue (CUDA events), after one
    warm-up call: for a kernel shorter than its launch's host cost (a
    decode step's attention), whose back-to-back launches ``cuda_ms`` would
    time at the host's pace."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)   # > 2 x host_s at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ptxas_of(log: str, pattern: str, name) -> dict:
    """ptxas' registers and spill bytes of each kernel of the build log
    whose mangled name matches ``pattern``, keyed by ``name(match)``."""
    import re
    ptx, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(pattern, ln)
            key = name(m) if m else None
        elif key and "registers" in ln:
            ptx.setdefault(key, {})["ptxas_registers"] = int(
                re.search(r"Used (\d+) registers", ln)[1])
        elif key and "spill" in ln:
            ptx.setdefault(key, {})["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", ln))
    return ptx


def f32_tile_resources(da, log: str) -> dict:
    """Every f32 ``lloyd_tile_kernel`` instantiation (BM 64 / 128 x the
    five (FT, update) rows): ptxas' registers and spill bytes from the
    build log, and the runtime's registers, local bytes, shared bytes and
    resident blocks an SM at Fp = 128 (``distance_argmin.tile_resources``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    ptx = ptxas_of(log, r"17lloyd_tile_kernelILi(\d+)ELb(\d)ELi(\d)E",
                   lambda m: f"bm{m[1]}_ft{m[2]}_upd{m[3]}")
    out = {}
    for bm in (64, 128):
        for ft, upd in ((0, 0), (0, 2), (0, 1), (1, 0), (1, 2), (0, 4)):
            name = f"bm{bm}_ft{ft}_upd{upd}"
            out[name] = {**ptx.get(name, {"spill_bytes": -1}),
                         **da.tile_resources(bm, bool(ft), upd, 128)}
    return out


def redesigned_resources(da, dai, log: str) -> dict:
    """The tensor-core int8 kernel, ``int8_tile_kernel<BM>`` (ptxas'
    registers and spills, and the runtime's at Fp = 128, the main path's,
    and 1024, where X streams), and every 2-byte tile kernel,
    ``lloyd_tile_mma_kernel<T, BM, kFT, kUpd>`` (ptxas' registers and
    spills, the runtime's at Fp = 128, where X is kept, and at Fp = 32, the
    PQ shape's; the FT ones also at 320, where X streams)."""
    import torch
    int8 = ptxas_of(log, r"16int8_tile_kernelILi(\d+)E",
                    lambda m: f"bm{m[1]}")
    out = {"int8_tile_kernel": {
        name: {**int8.get(name, {"spill_bytes": -1}),
               **{f"fp{fp}": dai.resources(int(name[2:]), fp)
                  for fp in (128, 1024)}}
        for name in ("bm64", "bm128")}}
    ptx = ptxas_of(
        log, r"21lloyd_tile_mma_kernelI(13__nv_bfloat16|6__half)Li(\d+)"
             r"ELb(\d)ELi(\d)E",
        lambda m: f"{'bf16' if 'bfloat' in m[1] else 'fp16'}_bm{m[2]}"
                  f"_ft{m[3]}_upd{m[4]}")
    mma = {}
    for dtype in ("bfloat16", "float16"):
        tag = "bf16" if dtype == "bfloat16" else "fp16"
        for bm in (64, 128):
            for ft, upd in ((0, 0), (0, 2), (0, 3), (1, 0), (1, 2), (0, 4)):
                name = f"{tag}_bm{bm}_ft{ft}_upd{upd}"
                mma[name] = {**ptx.get(name, {"spill_bytes": -1}), **{
                    f"fp{fp}": da.tile_resources(
                        bm, bool(ft), upd, fp, dtype=getattr(torch, dtype))
                    for fp in ((32, 128, 320) if ft else (32, 128))}}
    out["lloyd_tile_mma_kernel"] = mma
    return out


def attention_dmr_resources(cud, fa, libs) -> dict:
    """The f32 flash kernel, ``flash_f32_kernel<hd>`` at hd 64, 128 and
    256, and the DMR update's kernels: ptxas' registers and spill bytes
    from the build logs, and the runtime's resident blocks an SM,
    registers, local bytes and shared bytes (the f32 kernel at each hd, the
    DMR gather at 16-byte and 4-byte loads)."""
    f32 = ptxas_of(libs["fk_attention"].ptxas_log,
                   r"flash_f32_kernelILi(\d+)E", lambda m: f"hd{m[1]}")
    dmr = ptxas_of(libs["fk_kernels"].ptxas_log,
                   r"(dmr_[a-z]+_kernel)(?:IL[ib](\d)E)?",
                   lambda m: m[1] + (f"<{m[2]}>" if m[2] else ""))
    for v in (1, 4):
        dmr[f"dmr_gather_kernel<{v}>"] = {
            **dmr.get(f"dmr_gather_kernel<{v}>", {"spill_bytes": -1}),
            **cud.gather_resources(v)}
    return {"flash_f32_kernel": {
        f"hd{hd}": {**f32.get(f"hd{hd}", {"spill_bytes": -1}),
                    **fa.f32_resources(hd)} for hd in (64, 128, 256)},
            "dmr_kernels": dmr}


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def rel_ok(a, b, rtol: float) -> tuple[bool, float]:
    err = max_err(a, b)
    return err <= rtol * max(float(b.abs().max()), 1.0), err


UPDATE_LABELS = ("random", "sorted", "skewed", "one")


def update_labels(torch, kind: str, m: int, mp: int, k: int, seed: int):
    """The label cases of ``tests/test_torch_update_tree.py`` on the card,
    (mp,) int32 (0 past ``m``): random order, sorted, skewed (one cluster
    holds half the rows, 90 % of the clusters empty), all in one cluster."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "random":
        lab = rng.integers(0, k, m)
    elif kind == "sorted":
        lab = np.sort(rng.integers(0, k, m))
    elif kind == "skewed":
        few = rng.choice(k, size=max(k // 10, 2), replace=False)
        lab = rng.choice(few[1:], size=m)
        lab[rng.random(m) < 0.5] = few[0]
    else:
        lab = np.full(m, k - 1)
    out = torch.zeros(mp, dtype=torch.int32)
    out[:m] = torch.from_numpy(lab.astype(np.int32))
    return out.cuda()


def check_update_route(torch, up, ll, xp, amp, kp: int, true_m: int,
                       bm: int, what: str, order_matters: bool = True
                       ) -> dict:
    """The compact update (``update.compact_update``) and the tree kernel
    (``update.tree_sum``) held bit for bit to the parent's route:
    ``update_tiles_kernel``'s dense partials, then the torch tree; the
    per-tile pass against its plain version (present entries, rtol 1e-5;
    idx and counts equal). The control, where a cluster has three leaves
    (two add one way only): the leftmost and rightmost leaves of the
    busiest cluster swapped, in the entries' tree order (A) and in the
    dense partials (B). Both kernels must then give the torch tree's bits
    on the swapped leaves, and, where ``order_matters`` (f32 data, or
    2-byte rows scaled over many binades: a 2-byte cluster's f32 sums are
    often exact in any order), bits other than the unswapped result.
    ``torch.equal`` holds finite data only (NaN is unequal to itself)."""
    mp, fp = xp.shape
    nt = mp // bm
    sums_p = torch.empty((nt, kp, fp), device=xp.device)
    counts_p = torch.empty((nt, kp), device=xp.device)
    ll.tile_update(xp, amp, sums_p, counts_p, true_m=true_m, block_m=bm)
    want = (up.tree_sum_plain(sums_p), up.tree_sum_plain(counts_p))
    got = up.compact_update(xp, amp, kp, true_m=true_m, block_m=bm)
    expect(all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
           f"{what}: the compact update is not bit for bit the dense route")
    tree = (up.tree_sum(sums_p), up.tree_sum(counts_p))
    expect(all(bool(torch.equal(g, w)) for g, w in zip(tree, want)),
           f"{what}: the tree kernel is not bit for bit the torch tree")
    entries, ecnt, idx = up.update_entries(xp, amp, kp, true_m=true_m,
                                           block_m=bm)
    valid = (torch.arange(mp, device=xp.device) < true_m).view(nt, bm)
    p_ent, p_cnt, p_idx = up.update_entries_plain(
        xp.view(nt, bm, fp), amp.view(nt, bm), valid, kp)
    rows = idx[idx >= 0].long()
    ok, err = rel_ok(entries[rows], p_ent[rows], 1e-5)
    expect(ok and bool(torch.equal(idx, p_idx))
           and bool(torch.equal(ecnt[rows], p_cnt[rows])),
           f"{what}: update_entries disagrees with its plain version")
    del p_ent, p_cnt, p_idx
    per_k = (idx >= 0).sum(1)
    busy = int(per_k.argmax())
    broke = None
    if int(per_k[busy]) >= 3:
        slots = (idx[busy] >= 0).nonzero().squeeze(1)
        first, last = int(slots[0]), int(slots[-1])
        row_f, row_l = int(idx[busy, first]), int(idx[busy, last])
        idx[busy, first], idx[busy, last] = row_l, row_f
        swapped = torch.empty((kp, fp), device=xp.device)
        up.tree_passes(entries, idx, swapped, rows=kp, ntiles=nt, width=fp)
        t_f, t_l = row_f // bm, row_l // bm
        sums_p[[t_f, t_l], busy] = sums_p[[t_l, t_f], busy]
        ref_swapped = up.tree_sum_plain(sums_p)
        expect(bool(torch.equal(swapped[busy], ref_swapped[busy]))
               and bool(torch.equal(up.tree_sum(sums_p), ref_swapped)),
               f"{what}: on cluster {busy}'s leaves swapped (tiles {t_f}, "
               f"{t_l}) the kernels are not the torch tree's bits")
        broke = not torch.equal(ref_swapped[busy], want[0][busy])
        expect(broke or not order_matters,
               f"{what}: cluster {busy}'s leaves swapped kept the bits")
    return {"present_entries": int(per_k.sum()),
            "busiest_cluster_tiles": int(per_k.max()),
            "entries_err": err, "bitwise": True, "control_broke": broke}


def check_tree_batched(torch, up, sums, counts, what: str) -> None:
    """The tree kernel over a stack's f32 partials (P, T, Kp, Fp) at the
    problem stride, bit for bit the parent's ``movedim`` route. Control:
    problem 0's first and last tiles swapped, where the kernel must give
    the torch tree's bits on the swapped tiles and other bits than
    before."""
    want = (up.tree_sum_plain(sums.movedim(1, 0)),
            up.tree_sum_plain(counts.movedim(1, 0)))
    got = (up.tree_sum(sums, 1), up.tree_sum(counts, 1))
    expect(all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
           f"{what}: the strided tree is not bit for bit the movedim route")
    nt = sums.shape[1]
    if nt > 2:
        swapped = sums.clone()
        swapped[0, [0, nt - 1]] = swapped[0, [nt - 1, 0]]
        ref_swapped = up.tree_sum_plain(swapped[0])
        expect(bool(torch.equal(up.tree_sum(swapped, 1)[0], ref_swapped)),
               f"{what}: on two tiles swapped the strided tree is not the "
               f"torch tree's bits")
        expect(not torch.equal(ref_swapped, want[0][0]),
               f"{what}: two tiles swapped kept the bits")


def batched_sums(up, out, bm: int) -> tuple:
    """(sums (B, Kp, Fp), counts (B, Kp)) of the 2-byte batched step's
    entries (min, argmin, entries, ecnt, idx): one tree over B Kp rows."""
    nb, mp = out[1].shape
    sums, counts = up.reduce_entries(out[2], out[3], out[4], ntiles=mp // bm)
    return sums.view(nb, -1, sums.shape[1]), counts.view(nb, -1)


def same_problem(torch, up, got, i: int, one, bm: int, what: str) -> None:
    """Problem i of the 2-byte batched step's entries bit for bit
    ``lloyd_step``'s ``one`` on that problem alone: distances, labels, idx
    (at the problem's rows, shifted by its entry rows), the present
    entries and the tree's sums."""
    mp, kp = got[1].shape[1], one[4].shape[0]
    idx = got[4][i * kp:(i + 1) * kp]
    rows = one[4][one[4] >= 0].long()
    sums, counts = batched_sums(up, got, bm)
    expect(bool(torch.equal(got[0][i], one[0]))
           and bool(torch.equal(got[1][i], one[1]))
           and bool(torch.equal(idx, torch.where(one[4] >= 0,
                                                 one[4] + i * mp, -1)))
           and bool(torch.equal(got[2][rows + i * mp], one[2][rows]))
           and bool(torch.equal(got[3][rows + i * mp], one[3][rows]))
           and all(bool(torch.equal(g, w)) for g, w in zip(
               (sums[i], counts[i]), entry_sums(up, one, bm))),
           f"{what} is not bit for bit lloyd_step")


def batched_entries_control(torch, up, ll, xp, got, kp: int, true_m: int,
                            bm: int, what: str) -> dict:
    """The 2-byte batched step's entries and their tree bit for bit the
    dense route on the kernel's own labels: ``update_tiles_kernel``
    (``ll.tile_update``) per problem, then the tree kernel's dense variant
    at the problem stride. Control: one present entry of problem 0 plus
    1.0 must change that cluster's sum and nothing else."""
    nb, mp, fp = xp.shape
    nt = mp // bm
    sums_p = torch.empty((nb, nt, kp, fp), device=xp.device)
    counts_p = torch.empty((nb, nt, kp), device=xp.device)
    for i in range(nb):
        ll.tile_update(xp[i], got[1][i], sums_p[i], counts_p[i],
                       true_m=true_m, block_m=bm)
    want = (up.tree_sum(sums_p, 1), up.tree_sum(counts_p, 1))
    sums = batched_sums(up, got, bm)
    expect(all(bool(torch.equal(g, w)) for g, w in zip(sums, want)),
           f"{what}: the batched entries' tree is not bit for bit the dense "
           f"route")
    per_k = (got[4][:kp] >= 0).sum(1)
    busy = int(per_k.argmax())
    row = int(got[4][busy][got[4][busy] >= 0][0])
    moved = got[2].clone()
    moved[row, 0] += 1.0
    msums = batched_sums(up, (got[0], got[1], moved, got[3], got[4]), bm)[0]
    other = torch.ones(nb, kp, dtype=torch.bool, device=xp.device)
    other[0, busy] = False
    expect(not torch.equal(msums[0, busy], sums[0][0, busy])
           and bool(torch.equal(msums[other], sums[0][other])),
           f"{what}: a perturbed entry did not move its cluster's sum alone")
    return {"present_entries": int((got[4] >= 0).sum()),
            "entries_vs_dense_bitwise": True, "control_broke": True}


def entry_sums(up, out, bm: int) -> tuple:
    """(sums (Kp, Fp), counts (Kp,)) of a one-pass step's entries: the tree
    kernel over ``lloyd_step``'s outputs (min, argmin, entries, ecnt, idx)
    or ``lloyd_step_ft``'s (min, argmin, det, entries, ecnt, idx, ...)."""
    ent, ecnt, idx = out[2:5] if len(out) == 5 else out[3:6]
    return up.reduce_entries(ent, ecnt, idx, ntiles=out[1].shape[0] // bm)


def same_entries(torch, got, want) -> bool:
    """Two entry sets (entries, ecnt, idx) of one layout equal where they
    are written: the same idx table and, at every entry row it points at,
    the same sums and count (rows past a tile's entries are unwritten)."""
    e, n, i = got
    we, wn, wi = want
    rows = i[i >= 0].long()
    return (bool(torch.equal(i, wi)) and bool(torch.equal(e[rows], we[rows]))
            and bool(torch.equal(n[rows], wn[rows])))


def same_step(torch, up, dense, one, bm: int, what: str) -> None:
    """A dense one-pass output (a batched problem's: min, argmin, per-tile
    partials, counts) bit for bit ``lloyd_step``'s ``one``: distances and
    labels equal, the tree kernel over its partials equal to the tree over
    ``one``'s entries."""
    got = (up.tree_sum(dense[2]), up.tree_sum(dense[3]))
    expect(bool(torch.equal(dense[0], one[0]))
           and bool(torch.equal(dense[1], one[1]))
           and all(bool(torch.equal(g, w))
                   for g, w in zip(got, entry_sums(up, one, bm))),
           f"{what} is not bit for bit lloyd_step")


def same_entries_step(torch, got, one, what: str) -> None:
    """The pruned step's outputs (min, argmin, entries, ecnt, idx, tmin) at
    a mask that skips nothing bit for bit ``lloyd_step``'s ``one``:
    distances, labels and every entry."""
    expect(bool(torch.equal(got[0], one[0]))
           and bool(torch.equal(got[1], one[1]))
           and same_entries(torch, got[2:5], one[2:5]),
           f"{what} is not bit for bit lloyd_step")


def pruned_canon(up, out, bm: int) -> tuple:
    """The pruned step's and its plain version's outputs in one form:
    (min, argmin, sums (Kp, Fp), counts (Kp,), tmin), the kernel's entries
    through the tree over them, the plain version's dense partials through
    the torch tree."""
    if len(out) == 6:
        return (out[0], out[1], *up.reduce_entries(
            out[2], out[3], out[4], ntiles=out[1].shape[0] // bm), out[5])
    return (out[0], out[1], up.tree_sum_plain(out[2]),
            up.tree_sum_plain(out[3]), out[4])


def check_pruned_exact(torch, up, got, want, bm: int, what: str) -> None:
    """The pruned step against its plain version on exact (integer) data:
    labels, every entry (the plain partials in the entries' layout) and the
    trees over them bit for bit."""
    g, w = pruned_canon(up, got, bm), pruned_canon(up, want, bm)
    expect(bool(torch.equal(got[1], want[1])), f"{what}: argmin")
    expect(same_entries(torch, got[2:5],
                        up.dense_to_entries(want[2], want[3], bm)),
           f"{what}: entries")
    expect(bool(torch.equal(g[2], w[2])) and bool(torch.equal(g[3], w[3])),
           f"{what}: sums or counts")


def canon(up, name: str, out, bm: int) -> tuple:
    """A kernel's and its plain version's outputs in one form: a one-pass
    step's update as (sums (Kp, Fp), counts (Kp,)) -- the kernel's entries
    through the tree over them, the plain version's dense partials through
    the torch tree; every other output as it is."""
    if name == "lloyd_step":
        if len(out) == 5:
            return (out[0], out[1], *entry_sums(up, out, bm))
        return (out[0], out[1], up.tree_sum_plain(out[2]),
                up.tree_sum_plain(out[3]))
    if name == "lloyd_step_ft":
        if len(out) == 10:
            return (out[0], out[1], out[2], *entry_sums(up, out, bm),
                    out[8], out[9])
        return (out[0], out[1], out[2], up.tree_sum_plain(out[3]),
                up.tree_sum_plain(out[4]), out[5], out[6])
    return out


def peak_gb(fn) -> float:
    """Device memory a call allocates past what was held before it, GB."""
    import torch
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base_bytes) / 1e9


def onepass_rows(torch, ops, up, llft, plan, c, params, bound,
                 tag: str, launches: dict | None = None) -> tuple:
    """Phases 5 and 13: the one-pass steps as a fit runs them, at the
    phase-3 shape: ``ops.fused_lloyd`` and ``ops.fused_lloyd_ft`` (ms, and
    the device memory each allocates past X: the peak of a ``lloyd`` and a
    ``lloyd_ft`` step), the tree over ``lloyd_step``'s entries (ms and byte
    bound: the present entries read once, the sums written once), the
    entries-form verification of ``lloyd_step_ft``'s update with its gated
    recompute (ms; clean, so the gate stays shut) and, at 2 bytes, the C
    encodings' pre-pass. With ``launches`` (phase 5) also the rows of the
    verification kernel (against its plain version clean and with an update
    fault on a present pair: the tiles it flags; its byte bound: the
    entries, keys and counts of every row tile and the expected checksums
    read once) and of the tree kernel over these entries, the variant the
    one-pass fits run (bit for bit the torch tree over the present entries,
    ``pair_tree_plain``; beside ``index_add_`` of the entries by cluster;
    its bound as above)."""
    from repro_torch.kernels import distance_argmin_ft as daft
    from repro_torch.kernels import lloyd_step as ll
    bm = params.block_m
    mp, fp = plan.xp.shape
    nt = mp // bm
    cp, cn = ops._pad_centroids(c.to(plan.xp.dtype), K_FULL,
                                -(-K_FULL // params.block_k) * params.block_k,
                                fp)
    tiles = dict(block_m=bm, block_k=params.block_k, block_f=params.block_f)
    r = ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)
    n_present = int((r[4] >= 0).sum())
    q = list(llft.lloyd_step_ft(
        plan.xp, cp, cn, llft.no_injection().cuda(), plan.m,
        factor=ops.threshold_factor(fp, plan.xp.dtype), **tiles))
    ent_b = entry_bytes(n_present, F_FULL, K_FULL, nt)
    tree_b_ms, tree_b_by = bound(
        n_present * F_FULL, ent_b + 4.0 * (K_FULL * F_FULL + K_FULL))
    out = {f"onepass{tag}": {
        "present_entries": n_present,
        "fused_lloyd_ms": cuda_ms(lambda: ops.fused_lloyd(plan, c)),
        "fused_lloyd_ft_ms": cuda_ms(lambda: ops.fused_lloyd_ft(plan, c)),
        "lloyd_step_peak_gb": peak_gb(lambda: ops.fused_lloyd(plan, c)),
        "lloyd_ft_step_peak_gb": peak_gb(
            lambda: ops.fused_lloyd_ft(plan, c)),
        "entries_tree_ms": cuda_ms(lambda: entry_sums(up, r, bm)),
        "entries_tree_bound_ms": tree_b_ms,
        "entries_tree_bound_by": tree_b_by,
        "ft_verify_ms": cuda_ms(lambda: ops._verify_update_entries(
            plan, q[1], q[3:8], q[8], q[9], params)),
        "x_gb": plan.xp.numel() * plan.xp.element_size() / 1e9}}
    if plan.xp.dtype != torch.float32:
        out[f"onepass{tag}"]["encode_centroids_ms"] = cuda_ms(
            lambda: daft.encode_centroids(cp))
    rows = []
    if launches is not None:
        ufactor = ops.threshold_factor(bm, plan.xp.dtype)

        def verify():
            return llft.verify_entries(*q[3:5], *q[6:10], block_m=bm,
                                       factor=ufactor)

        def verify_plain():
            return llft.verify_entries_plain(*q[3:5], *q[6:10], block_m=bm,
                                             factor=ufactor)
        got, want = verify(), verify_plain()
        expect(int(got[0]) == int(want[0]) == 0,
               f"verify_entries flags {int(got[0])} / plain {int(want[0])} "
               f"clean tiles")
        hit = 3                      # its first entry row holds a cluster
        row = hit * bm
        q[3][row, 5] += 2.0 ** 19
        got, want = verify(), verify_plain()
        expect(int(got[0]) == int(want[0]) == 1
               and int(got[1]) == int(want[1]) == hit,
               f"verify_entries on a fault in tile {hit}: {int(got[0])} "
               f"at {int(got[1])}, plain {int(want[0])} at {int(want[1])}")
        q[3][row, 5] -= 2.0 ** 19
        b_ms, b_by = bound(2.0 * n_present * F_FULL, ent_b + 8.0 * mp
                           + 4.0 * nt * (2 * F_FULL + 2))
        rows.append({
            "name": "verify_entries", "route": "cuda",
            "source": "src/repro_torch/csrc/fk_update.cu",
            "replaces": "src/repro/kernels/ops.py:771 (_verify_update_"
                        "partials, XLA in the reference; the port's own "
                        "kernel)",
            "launches": launches["verify_entries"], "max_abs_err": 0.0,
            "ms": cuda_ms(verify), "plain_ms": cuda_ms(verify_plain, reps=2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        out[f"onepass{tag}"]["verify_entries_ms"] = rows[-1]["ms"]
        rows.append(entries_tree_row(torch, up, r, bm, launches,
                                     out[f"onepass{tag}"]))
    del r, q
    torch.cuda.empty_cache()
    return out, rows


def entries_tree_row(torch, up, r, bm: int, launches: dict,
                     rec: dict) -> dict:
    """The ``tree_reduce`` row: the sparse tree over ``lloyd_step``'s
    entries ``r`` as ``update.reduce_entries`` runs it, against the torch
    tree over the same present entries (``pair_tree_plain`` over their
    slots), bit for bit; the library call is ``index_add_`` of the entries
    (sums and counts) by cluster. ``rec`` holds the entries' tree ms and
    bound (``onepass_rows``)."""
    ent, ecnt, idx = r[2:5]
    kp, levels = idx.shape[0], idx.shape[1].bit_length() - 1
    nz = (idx >= 0).nonzero()
    k_of, slot = nz[:, 0], nz[:, 1]
    rows_of = idx[k_of, slot].long()

    def tree():
        return entry_sums(up, r, bm)

    def tree_plain():
        return (up.pair_tree_plain(ent[rows_of], slot, k_of, levels, kp),
                up.pair_tree_plain(ecnt[rows_of], slot, k_of, levels, kp))
    got, want = tree(), tree_plain()
    expect(all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
           "the tree kernel over lloyd_step's entries is not bit for bit "
           "the torch tree over them")
    # entry row -> its cluster; rows no idx slot points at go to row kp
    cluster = torch.full((ent.shape[0],), kp, dtype=torch.long,
                         device=ent.device)
    cluster[rows_of] = k_of
    acc = torch.zeros((kp + 1, ent.shape[1]), device=ent.device)
    acc_c = torch.zeros(kp + 1, device=ent.device)
    return {"name": "tree_reduce", "route": "cuda",
            "source": "src/repro_torch/csrc/fk_update.cu",
            "replaces": "src/repro/kernels/ops.py:510 (_tree_sum, XLA in "
                        "the reference; the port's own kernel)",
            "launches": launches["tree_reduce"], "max_abs_err": 0.0,
            "ms": cuda_ms(tree), "plain_ms": cuda_ms(tree_plain, reps=2),
            "bound_ms": rec["entries_tree_bound_ms"],
            "bound_by": rec["entries_tree_bound_by"],
            "library_ms": cuda_ms(lambda: (acc.index_add_(0, cluster, ent),
                                           acc_c.index_add_(0, cluster,
                                                            ecnt)))}


def entry_bytes(n_present: int, f: int, k: int, nt: int) -> float:
    """The bytes a one-pass step's entries take once: each present (tile,
    cluster) pair's F sums and count, and the idx table of the true K
    clusters over the tree's 2^L slots."""
    return n_present * (4.0 * f + 4.0) + 4.0 * k * (1 << (nt - 1)
                                                    .bit_length())


def check_onepass(torch, up, ll, r, xp, kp: int, true_m: int, bm: int,
                  what: str, order_matters: bool = True) -> dict:
    """``lloyd_step``'s entries ``r`` held to the dense route on its own
    labels: ``tile_update``'s dense partials (the reference's layout), then
    the torch tree, bit for bit; the entries themselves bit for bit
    ``update_entries``' (one writer). Control: the busiest cluster's first
    and last leaves swapped in idx must give the torch tree's bits on the
    swapped dense partials and, where ``order_matters``, other bits than
    the unswapped result."""
    mp, fp = xp.shape
    nt = mp // bm
    am = r[1]
    sums_p = torch.empty((nt, kp, fp), device=xp.device)
    counts_p = torch.empty((nt, kp), device=xp.device)
    ll.tile_update(xp, am, sums_p, counts_p, true_m=true_m, block_m=bm)
    want = (up.tree_sum_plain(sums_p), up.tree_sum_plain(counts_p))
    expect(all(bool(torch.equal(g, w))
               for g, w in zip(entry_sums(up, r, bm), want)),
           f"{what}: lloyd_step's entries are not bit for bit the dense "
           f"route")
    ent, ecnt, idx = r[2:5]
    e2, c2, i2 = up.update_entries(xp, am, kp, true_m=true_m, block_m=bm)
    rows = idx[idx >= 0].long()
    expect(bool(torch.equal(i2, idx)) and bool(torch.equal(e2[rows],
                                                           ent[rows]))
           and bool(torch.equal(c2[rows], ecnt[rows])),
           f"{what}: lloyd_step's entries are not update_entries'")
    del e2, c2, i2
    per_k = (idx >= 0).sum(1)
    busy = int(per_k.argmax())
    broke = None
    if int(per_k[busy]) >= 3:
        slots = (idx[busy] >= 0).nonzero().squeeze(1)
        first, last = int(slots[0]), int(slots[-1])
        row_f, row_l = int(idx[busy, first]), int(idx[busy, last])
        sw = idx.clone()
        sw[busy, first], sw[busy, last] = row_l, row_f
        swapped = up.reduce_entries(ent, ecnt, sw, ntiles=nt)[0]
        t_f, t_l = row_f // bm, row_l // bm
        sums_p[[t_f, t_l], busy] = sums_p[[t_l, t_f], busy]
        ref_swapped = up.tree_sum_plain(sums_p)
        expect(bool(torch.equal(swapped[busy], ref_swapped[busy])),
               f"{what}: on cluster {busy}'s leaves swapped the tree over "
               f"the entries is not the torch tree's bits")
        broke = not torch.equal(ref_swapped[busy], want[0][busy])
        expect(broke or not order_matters,
               f"{what}: cluster {busy}'s leaves swapped kept the bits")
    return {"present_entries": int(per_k.sum()), "bitwise": True,
            "control_broke": broke}


def check_ft_cases(torch, ops, llft, plan, c, cp, cn, params, am, k: int,
                   what: str) -> dict:
    """``ops.fused_lloyd_ft`` under the tentpole's injection cases, each
    against the dense route (``lloyd_step_ft.lloyd_ft_dense_plain``: the
    fault in the dense block, the dense verification): an update fault on
    a present (tile, cluster) pair of row tile 1, on an absent one, in a
    padded cluster row (k >= K), a distance fault, both slots. The
    detections equal the dense route's and the slots armed; the corrected
    step is bit for bit the clean one."""
    bm, kp = params.block_m, cp.shape[0]
    dt = plan.xp.dtype
    clean = ops.fused_lloyd_ft(plan, c)
    tile = am[bm:2 * bm].tolist()
    absent = next(j for j in range(k) if j not in tile)
    cases = {"present": {"update": (1, tile[5], 7, 2.0 ** 19)},
             "absent": {"update": (1, absent, 3, -2.0 ** 20)},
             "padded": {"update": (1, kp - 1, 11, 2.0 ** 21)},
             "distance": {"distance": (7, 0, 1, 9, 5, -2.0 ** 21)},
             "both": {"distance": (7, 0, 1, 9, 5, -2.0 ** 21),
                      "update": (1, absent, 0, 2.0 ** 22)}}
    expect(kp > k, f"{what}: no padded cluster row")
    rec = {}
    for name, arm in cases.items():
        inj = llft.make_injection(**arm).cuda()
        hit = ops.fused_lloyd_ft(plan, c, inj=inj)
        dense = llft.lloyd_ft_dense_plain(
            plan.xp, cp, cn, inj, plan.m, bm, params.block_k,
            params.block_f, ops.threshold_factor(plan.xp.shape[1], dt),
            ops.threshold_factor(bm, dt))
        rec[name] = {"det": int(hit[4]), "dense_det": int(dense[2])}
        expect(int(hit[4]) == int(dense[2]) == len(arm),
               f"{what} {name}: detected {int(hit[4])}, the dense route "
               f"{int(dense[2])}, {len(arm)} planted")
        expect(all(bool(torch.equal(a, b)) for a, b in zip(hit[:4],
                                                            clean[:4])),
               f"{what} {name}: the corrected step is not bitwise clean")
        del hit, dense
    return rec


def phase_kernels(torch, ops, kern) -> dict:
    """Phase 2: each kernel against its plain version on the card; the
    compact update and the tree kernel bit for bit the parent's dense route
    at the kernel's labels and the label cases of the CPU tests (T = 513
    row tiles: the tree's carry)."""
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import update as up
    da, ll, daft, llft = kern
    out = {"phase": 2, "shapes": []}
    # F = 300 (Fp = 320, ten feature chunks) beside F = 100: the f32 tile
    # kernel's staging ring and X encodings at more chunks than four
    for k, f in ((1000, F_SMALL), (100, F_SMALL), (1000, F_WIDE)):
        seed = SEED + k + (f if f != F_SMALL else 0)
        x_np, _ = make_blobs(M_SMALL, f, k, seed=seed)
        x = torch.from_numpy(x_np).cuda()
        c = torch.from_numpy(blob_centers(k, f, seed)).cuda()
        params = ops.clamp_params(M_SMALL, k, f, ops.DEFAULT_PARAMS)
        plan = ops.plan_data(x, params)
        kp = -(-k // params.block_k) * params.block_k
        cp, cn = ops._pad_centroids(c, k, kp, plan.xp.shape[1])
        tiles = dict(block_m=params.block_m, block_k=params.block_k,
                     block_f=params.block_f)
        factor = ops.threshold_factor(plan.xp.shape[1], torch.float32)
        rec = {"k": k, "f": f, "fp": plan.xp.shape[1],
               "centroid_tiles": kp // params.block_k, "tol_rel": 1e-5}

        md, am = da.distance_argmin(plan.xp, cp, cn, **tiles)
        md_p, am_p = da.distance_argmin_plain(plan.xp, cp, cn)
        ok, rec["distance_argmin_err"] = rel_ok(md, md_p, 1e-5)
        expect(ok, f"distance_argmin min distances K={k} F={f}")
        expect(bool((am == am_p).all()), f"distance_argmin labels K={k} F={f}")

        r = ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)
        r_p = ll.lloyd_step_plain(plan.xp, cp, cn, plan.m, params.block_m)
        expect(bool((r[1] == am).all()) and bool(torch.equal(r[0], md)),
               f"lloyd_step assignment differs from distance_argmin K={k} "
               f"F={f}")
        r_sums = entry_sums(up, r, params.block_m)
        ok, rec["lloyd_step_sums_err"] = rel_ok(
            r_sums[0], up.tree_sum_plain(r_p[2]), 1e-5)
        expect(ok, f"lloyd_step sums K={k} F={f}")
        expect(bool(torch.equal(r_sums[1], up.tree_sum_plain(r_p[3]))),
               f"lloyd_step counts K={k} F={f}")
        rec["onepass_entries"] = check_onepass(
            torch, up, ll, r, plan.xp, kp, plan.m, params.block_m,
            f"lloyd_step K={k} F={f}")
        # fused = lloyd = clean lloyd_ft, at the ops level
        fl = ops.fused_lloyd(plan, c)
        fused = ops.tiled_update(plan, fl[0], k)
        expect(all(bool(torch.equal(a, b)) for a, b in zip(fl[2:], fused)),
               f"fused_lloyd sums are not the two-pass update's K={k} F={f}")
        mp = plan.xp.shape[0]
        rec["update_routes"] = {"kernel_labels": check_update_route(
            torch, up, ll, plan.xp, am, kp, plan.m, params.block_m,
            f"labels of distance_argmin K={k} F={f}")}
        for i, kind in enumerate(UPDATE_LABELS):
            rec["update_routes"][kind] = check_update_route(
                torch, up, ll, plan.xp,
                update_labels(torch, kind, plan.m, mp, k, SEED + i), kp,
                plan.m, params.block_m, f"{kind} labels K={k} F={f}")
        expect(bool(torch.equal(up.tree_sum(r_p[2]),
                                up.tree_sum_plain(r_p[2])))
               and bool(torch.equal(up.tree_sum(r_p[3]),
                                    up.tree_sum_plain(r_p[3]))),
               f"the tree kernel on dense one-pass partials is not bit for "
               f"bit the torch tree K={k} F={f}")

        no_d = daft.no_injection().cuda()
        f_md, f_am, f_det = daft.distance_argmin_ft(
            plan.xp, cp, cn, no_d, factor=factor, **tiles)
        p_md, p_am, p_det = daft.distance_argmin_ft_plain(
            plan.xp, cp, cn, no_d, params.block_m, params.block_k,
            params.block_f, factor)
        rec["clean_det"] = int(f_det.sum())
        expect(rec["clean_det"] == 0 and int(p_det.sum()) == 0,
               f"clean distance_argmin_ft detected {rec['clean_det']} "
               f"K={k} F={f}")
        expect(bool(torch.equal(f_md, md)) and bool(torch.equal(f_am, am)),
               f"clean distance_argmin_ft differs from distance_argmin "
               f"K={k} F={f}")
        ok, rec["distance_argmin_ft_err"] = rel_ok(f_md, p_md, 1e-5)
        expect(ok and bool((p_am == am).all()),
               f"distance_argmin_ft vs plain K={k} F={f}")
        inj = ops.plan_injection_tile(M_SMALL, k, f, params,
                                      row=M_SMALL // 3, col=k - 3, f_step=1,
                                      delta=2.0 ** 20).cuda()
        _, i_am, i_det = daft.distance_argmin_ft(plan.xp, cp, cn, inj,
                                                 factor=factor, **tiles)
        rec["fault_det"] = int(i_det.sum())
        expect(rec["fault_det"] == 1 and bool(torch.equal(i_am, am)),
               f"distance fault not corrected once K={k} F={f}")

        no_l = llft.no_injection().cuda()
        q = llft.lloyd_step_ft(plan.xp, cp, cn, no_l, plan.m, factor=factor,
                               **tiles)
        q_p = llft.lloyd_step_ft_plain(plan.xp, cp, cn, no_l, plan.m,
                                       params.block_m, params.block_k,
                                       params.block_f, factor)
        expect(int(q[2].sum()) == 0,
               f"clean lloyd_step_ft detected K={k} F={f}")
        expect(bool(torch.equal(q[5], r[4])) and all(
            bool(torch.equal(a, b)) for a, b in zip(
                entry_sums(up, q, params.block_m), r_sums)),
               f"lloyd_step_ft entries / sums differ from lloyd_step "
               f"K={k} F={f}")
        ok, rec["lloyd_step_ft_ucheck_err"] = rel_ok(q[8], q_p[5], 1e-5)
        expect(ok and bool(torch.equal(q[9], q_p[6])),
               f"lloyd_step_ft update checksums vs plain K={k} F={f}")
        clean = ops.fused_lloyd_ft(plan, c, inj=no_l)
        expect(int(clean[4]) == 0 and all(
            bool(torch.equal(a, b)) for a, b in zip(clean[:4], fl)),
               f"clean fused_lloyd_ft detected {int(clean[4])} or is not "
               f"fused_lloyd K={k} F={f}")
        rec["ft_cases"] = check_ft_cases(torch, ops, llft, plan, c, cp, cn,
                                         params, r[1], k, f"f32 K={k} F={f}")
        out["shapes"].append(rec)
        del plan, r, r_p, q, q_p, fl, fused, clean
        torch.cuda.empty_cache()
    # the update at the other row tile (64 rows: 1025 tiles, a carry) and
    # at features past one warp's 128 (F 300 -> Fp 320)
    out["update_routes_tiles"] = {}
    for bm, f in ((64, F_SMALL), (128, 300)):
        x_np, _ = make_blobs(M_SMALL, f, 100, seed=SEED + f)
        params = ops.clamp_params(M_SMALL, 100, f,
                                  ops.KernelParams(bm, 128, 32))
        plan = ops.plan_data(torch.from_numpy(x_np).cuda(), params)
        out["update_routes_tiles"][f"bm{bm}_f{f}"] = check_update_route(
            torch, up, ll, plan.xp,
            update_labels(torch, "random", plan.m, plan.xp.shape[0], 100,
                          SEED), 128, plan.m, bm, f"row tile {bm}, F {f}")
        del plan
        torch.cuda.empty_cache()
    return out


def compact_update_rows(torch, up, plan, am, kp: int, bm: int, sums_p,
                        counts_p, x_bytes: float, bound, launches: dict,
                        tag: str) -> tuple[dict, list]:
    """Phases 5 and 13: the compact update at the phase-3 shape. ``sums_p``
    and ``counts_p`` are the parent route's dense partials of the labels
    ``am`` (``tile_update`` over every tile): the per-tile pass then the
    tree over its entries, and ``update.compact_update``, are held bit for
    bit to the torch tree over them and timed apart and together beside
    ``index_add_`` and their byte bounds (at the true M, K, F: X and the
    labels read once, the present entries written once and read once); the
    per-tile pass against its plain version, and its row."""
    mp, fp = plan.xp.shape
    nt = mp // bm
    dev = plan.xp.device
    what = tag or "float32"
    want = (up.tree_sum_plain(sums_p), up.tree_sum_plain(counts_p))

    def entries():
        return up.update_entries(plan.xp, am, kp, true_m=plan.m, block_m=bm)
    ent, ecnt, idx = entries()
    out = (torch.empty((kp, fp), device=dev), torch.empty(kp, device=dev))

    def reduce():
        up.tree_passes(ent, idx, out[0], rows=kp, ntiles=nt, width=fp)
        up.tree_passes(ecnt, idx, out[1], rows=kp, ntiles=nt, width=1)
        return out

    def compact():
        return up.compact_update(plan.xp, am, kp, true_m=plan.m, block_m=bm)
    for route, got in (("the per-tile pass + tree", reduce()),
                       ("compact_update", compact())):
        expect(all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
               f"{what} {route} is not bit for bit the dense route at the "
               f"phase-3 shape")
    del want
    valid = (torch.arange(mp, device=dev) < plan.m).view(nt, bm)

    def entries_plain():
        return up.update_entries_plain(plan.xp.view(nt, bm, fp),
                                       am.view(nt, bm), valid, kp)
    p_ent, p_cnt, p_idx = entries_plain()
    present = idx[idx >= 0].long()
    ok, err = rel_ok(ent[present], p_ent[present], 1e-5)
    expect(ok and bool(torch.equal(idx, p_idx))
           and bool(torch.equal(ecnt[present], p_cnt[present])),
           f"{what} update_entries disagrees with its plain version")
    n_present = present.numel()
    del p_ent, p_cnt, p_idx, present
    torch.cuda.empty_cache()
    ent_bytes = n_present * (4.0 * F_FULL + 8.0)
    out_bytes = 4.0 * (K_FULL * F_FULL + K_FULL)
    b_ent = bound(M_FULL * F_FULL, x_bytes + 4.0 * M_FULL + ent_bytes)
    b_all = bound(M_FULL * F_FULL,
                  x_bytes + 4.0 * M_FULL + 2.0 * ent_bytes + out_bytes)
    am_long = am.long()
    rec = {"present_entries": n_present,
           "update_entries_ms": cuda_ms(entries),
           "update_tree_ms": cuda_ms(reduce),
           "update_tree_bound_ms": bound(n_present * F_FULL,
                                         ent_bytes + out_bytes)[0],
           "compact_update_ms": cuda_ms(compact),
           "compact_update_bound_ms": b_all[0],
           "index_add_ms": cuda_ms(lambda: torch.zeros(
               kp, fp, dtype=plan.xp.dtype, device=dev).index_add_(
                   0, am_long, plan.xp))}
    rec["compact_over_index_add"] = (rec["compact_update_ms"]
                                     / rec["index_add_ms"])
    row = {"name": "update_entries" + (f"_{tag}" if tag else ""),
           "route": "cuda", "source": "src/repro_torch/csrc/fk_update.cu",
           "replaces": "src/repro/kernels/lloyd_step.py:162",
           "launches": launches["update_entries"], "max_abs_err": err,
           "ms": rec["update_entries_ms"],
           "plain_ms": cuda_ms(entries_plain, reps=2),
           "bound_ms": b_ent[0], "bound_by": b_ent[1], "library_ms": None}
    return rec, [row]


def pq_stack(torch, b: int, n: int, f: int, k: int):
    """Problem i of a stack is ``make_blobs(n, f, k, seed=i)``; the blob
    centres of each problem serve as its centroids where a check needs
    wide label margins."""
    import numpy as np
    from repro_torch.data.blobs import make_blobs
    x = np.stack([make_blobs(n, f, k, seed=i)[0] for i in range(b)])
    c = np.stack([blob_centers(k, f, i) for i in range(b)])
    return torch.from_numpy(x).cuda(), torch.from_numpy(c).cuda()


def round_inputs(torch, kpp, hw, x):
    """The inputs of a second seeding round (the first run by the plain
    version, so the running minimum is real): (xp, xn, c, d2, block_n)."""
    import torch.nn.functional as F
    b, n, _ = x.shape
    bn = kpp.clamp_init_block(n, hw.INIT_BLOCK_N)
    np_ = -(-n // bn) * bn
    xp = F.pad(x, (0, 0, 0, np_ - n)).contiguous()
    xn = (xp * xp).sum(2)
    d2 = torch.where(torch.arange(np_, device=x.device) < n, torch.inf,
                     0.0).expand(b, np_).contiguous()
    d2, _ = kpp.kmeanspp_round_plain(xp, xn, xp[:, 3:4].contiguous(), d2, bn)
    return xp, xn, xp[:, n // 2:n // 2 + 1].contiguous(), d2, bn


def phase_batched_kernels(torch, ops, hw, ll, kpp) -> dict:
    """Phase 6: the batched step and the seeding round against their plain
    versions on the card, batched problems against lloyd_step alone, and
    the tree kernel over the batched partials at the problem stride bit for
    bit the parent's movedim route (timed beside it at the PQ shape)."""
    from repro_torch.kernels import update as up
    out = {"phase": 6, "shapes": []}
    for b, n, f, k in ((B_PQ, N_PQ, F_PQ, K_PQ), (7, 10_007, 20, 200),
                       (7, 10_007, 20, 100)):
        x, c = pq_stack(torch, b, n, f, k)
        params = ops.clamp_params(n, k, f, ops.DEFAULT_PARAMS)
        plan = ops.plan_data_batched(x, params)
        kp = -(-k // params.block_k) * params.block_k
        cp, cn = ops._pad_centroids(c, k, kp, plan.xp.shape[2])
        tiles = dict(block_m=params.block_m, block_k=params.block_k,
                     block_f=params.block_f)
        rec = {"b": b, "n": n, "f": f, "k": k,
               "centroid_tiles": kp // params.block_k, "tol_rel": 1e-5}
        got = ll.lloyd_step_batched(plan.xp, cp, cn, n, **tiles)
        want = ll.lloyd_step_batched_plain(plan.xp, cp, cn, n,
                                           params.block_m)
        expect(bool(torch.equal(got[1], want[1])),
               f"lloyd_step_batched labels vs plain {rec}")
        ok, rec["lloyd_step_batched_min_err"] = rel_ok(got[0], want[0], 1e-5)
        expect(ok, f"lloyd_step_batched distances vs plain {rec}")
        ok, rec["lloyd_step_batched_sums_err"] = rel_ok(got[2], want[2], 1e-5)
        expect(ok, f"lloyd_step_batched sums vs plain {rec}")
        expect(bool(torch.equal(got[3], want[3])),
               f"lloyd_step_batched counts vs plain {rec}")
        del want
        for i in (0, b // 2, b - 1):
            one = ll.lloyd_step(plan.xp[i], cp[i], cn[i], n, **tiles)
            same_step(torch, up, [g[i] for g in got], one, params.block_m,
                      f"batched problem {i} {rec}")
        check_tree_batched(torch, up, got[2], got[3],
                           f"batched partials {rec}")
        if b == B_PQ:
            nt = got[2].shape[1]
            rec["tree_batched"] = {
                "ms": cuda_ms(lambda: (up.tree_sum(got[2], 1),
                                       up.tree_sum(got[3], 1))),
                "movedim_torch_tree_ms": cuda_ms(lambda: (
                    up.tree_sum_plain(got[2].movedim(1, 0)),
                    up.tree_sum_plain(got[3].movedim(1, 0))), reps=2),
                "library_ms": cuda_ms(lambda: (got[2].sum(1),
                                               got[3].sum(1))),
                "bound_ms": 1e3 * 4.0 * b * nt * k * (f + 1) / hw.HBM_BW}
        del got, one

        xp, xn, c1, d2, bn = round_inputs(torch, kpp, hw, x)
        d2k, tsk = kpp.kmeanspp_round(xp, xn, c1, d2, block_n=bn)
        d2p, tsp = kpp.kmeanspp_round_plain(xp, xn, c1, d2, bn)
        rec["round_block_n"] = bn
        rec["round_d2_err"] = max_err(d2k, d2p)
        expect(rec["round_d2_err"] <= 1e-5 * float(xn.max()),
               f"kmeanspp_round d2 vs plain beyond 1e-5 x max xn {rec}")
        rec["round_tile_sum_rel_err"] = float(
            ((tsk - tsp).abs() / tsp.abs()).max())
        expect(rec["round_tile_sum_rel_err"] <= 1e-5,
               f"kmeanspp_round tile sums vs plain {rec}")
        expect(bool((d2k[:, n:] == 0).all()),
               f"kmeanspp_round padded rows are not 0 {rec}")
        again = kpp.kmeanspp_round(xp, xn, c1, d2, block_n=bn)
        expect(bool(torch.equal(again[0], d2k))
               and bool(torch.equal(again[1], tsk)),
               f"kmeanspp_round does not repeat bit for bit {rec}")
        out["shapes"].append(rec)
        del x, c, plan, cp, cn, xp, xn, d2, d2k, d2p, again
        torch.cuda.empty_cache()
    return out


def device_trace(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity):
    the kernels it put on the card, the card's busy time (the union of its
    kernel, copy and set intervals) against the traced wall time, and the
    five kernels that took the most device time. Busy and idle are None
    when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end, _ in dev:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    per_name: dict = {}
    for start, end, name in kernels:
        per_name[name] = per_name.get(name, 0.0) + (end - start) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    busy_ms = busy_us / 1e3 if dev else None
    return {"kernels": len(kernels), "device_events": len(dev),
            "busy_ms": busy_ms, "wall_ms": wall_ms,
            "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "top_kernels_ms": {name[:80]: ms for name, ms in top}}


def seeds_are_rows(torch, x, seeds) -> bool:
    """Every seed of problem i equals some row of problem i exactly."""
    for xi, si in zip(x, seeds):
        for part in si.split(32):
            if not bool((xi[None] == part[:, None]).all(-1).any(-1).all()):
                return False
    return True


def dense_tree_row(torch, up, ll, plan, cp, cn, tiles: dict, bound,
                   launches: int) -> dict:
    """The ``tree_reduce_dense`` row: the tree kernel's dense variant over
    the batched kernel's partials (B, T, Kp, Fp) at the problem stride, as
    ``fused_lloyd_batched`` runs it, bit for bit the torch tree after a
    ``movedim``; the library call is ``sum`` over the tiles. ``launches``:
    the dense launches of the batched fit (phase 9 adds the pruned fits').
    Bound: the partials of the true K and F read once, the sums written
    once."""
    out = ll.lloyd_step_batched(plan.xp, cp, cn, N_PQ, **tiles)
    sums, counts = out[2], out[3]
    del out
    b, nt = sums.shape[:2]

    def tree():
        return up.tree_sum(sums, 1), up.tree_sum(counts, 1)

    def tree_plain():
        return (up.tree_sum_plain(sums.movedim(1, 0)),
                up.tree_sum_plain(counts.movedim(1, 0)))
    expect(all(bool(torch.equal(g, w)) for g, w in zip(tree(), tree_plain())),
           "the dense tree over the batched partials is not bit for bit the "
           "torch tree")
    b_ms, b_by = bound(b * nt * K_PQ * F_PQ,
                       4.0 * b * (nt + 1) * (K_PQ * F_PQ + K_PQ))
    row = {"name": "tree_reduce_dense", "route": "cuda",
           "source": "src/repro_torch/csrc/fk_update.cu",
           "replaces": "src/repro/kernels/ops.py:510 (_tree_sum, XLA in the "
                       "reference; the port's own kernel)",
           "launches": launches, "max_abs_err": 0.0,
           "ms": cuda_ms(tree, reps=20), "plain_ms": cuda_ms(tree_plain,
                                                            reps=3),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(lambda: (sums.sum(1), counts.sum(1)),
                                 reps=20)}
    del sums, counts
    torch.cuda.empty_cache()
    return row


def phase_batched_fit(torch, ops, hw, ll, kpp, bound, KMeans,
                      BatchedKMeans) -> tuple[dict, list]:
    """Phase 7: BatchedKMeans at the PQ shape, then its kernels' rows."""
    import numpy as np
    x, _ = pq_stack(torch, B_PQ, N_PQ, F_PQ, K_PQ)
    base = dict(n_clusters=K_PQ, random_state=SEED)
    from repro_torch.kernels import update as up
    wrappers = {"lloyd_step_batched": ll.lloyd_step_batched,
                "kmeanspp_round": kpp.kmeanspp_round,
                "tree_reduce": up.tree_reduce}
    for w in wrappers.values():
        w.launches = 0
    up.tree_reduce.kernel_launches.update(sparse=0, dense=0)
    bkm = BatchedKMeans(init="kmeans++-fused", max_iter=PQ_ITERS, tol=0.0,
                        **base)
    seeds, seed_s = wall(lambda: bkm.init_centroids(x))
    again = BatchedKMeans(init="kmeans++-fused", **base).init_centroids(x)
    _, fit_s = wall(lambda: bkm.fit(x, centroids=seeds))
    labels = bkm.predict(x)
    score = bkm.score(x)
    conv = BatchedKMeans(max_iter=100, tol=1e-4, **base).fit(
        x, centroids=seeds)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    tree_kinds = dict(up.tree_reduce.kernel_launches)
    for name, n in launches.items():
        expect(n > 0, f"{name} was not launched on the batched path")
    expect(bool(torch.equal(seeds, again)),
           "fused seeding does not repeat bit for bit")
    expect(seeds_are_rows(torch, x, seeds),
           "a fused seed is not a row of its problem")
    expect(all(torch.unique(s, dim=0).shape[0] == K_PQ for s in seeds),
           "fused seeding chose a row twice")
    expect(np.isfinite(score).all() and bool((score < 0).all()),
           f"batched score {score}")

    # the loop of single-problem one-pass fits from the same seeds
    singles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(B_PQ):
        singles.append(KMeans(K_PQ, backend="lloyd", max_iter=PQ_ITERS,
                              tol=0.0, random_state=SEED + i)
                       .fit(x[i], centroids=seeds[i]))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    for i, one in enumerate(singles):
        expect(bool(torch.equal(one.cluster_centers_,
                                bkm.cluster_centers_[i]))
               and bool(torch.equal(one.labels_, bkm.labels_[i])),
               f"batched problem {i} is not bit for bit its single fit")
        expect(bool(torch.equal(one.predict(x[i]), labels[i])),
               f"batched predict of problem {i} differs from its single fit")
    inertia_rel = max(abs(one.inertia_ - bkm.inertia_[i]) / one.inertia_
                      for i, one in enumerate(singles))
    expect(inertia_rel <= 1e-6, f"batched inertia vs single {inertia_rel}")
    rec = {"phase": 7, "b": B_PQ, "n": N_PQ, "f": F_PQ, "k": K_PQ,
           "seeding_s": seed_s, "n_iter": bkm.n_iter_.tolist()[:3],
           "batched_ms_per_iter": 1e3 * fit_s / PQ_ITERS,
           "single_loop_ms_per_iter": 1e3 * loop_s / PQ_ITERS,
           "singles_bitwise": B_PQ, "inertia_max_rel_err": inertia_rel,
           "n_host_syncs": bkm._n_host_syncs,
           "tol_1e-4_n_iter": conv.n_iter_.tolist(),
           "score_sum": float(score.sum()), "launches": launches,
           "tree_reduce_variants": tree_kinds}
    del singles, conv, again
    torch.cuda.empty_cache()
    # where a step's time goes: one traced batched fit and one traced
    # single-problem fit, 25 steps each at tol = 0 (after the counts)
    rec["trace_batched_fit"] = device_trace(torch, lambda: BatchedKMeans(
        max_iter=PQ_ITERS, tol=0.0, **base).fit(x, centroids=seeds))
    rec["trace_single_fit"] = device_trace(torch, lambda: KMeans(
        K_PQ, backend="lloyd", max_iter=PQ_ITERS, tol=0.0,
        random_state=SEED).fit(x[0], centroids=seeds[0]))
    torch.cuda.empty_cache()

    # kernel rows at the PQ shape
    params = ops.clamp_params(N_PQ, K_PQ, F_PQ, ops.DEFAULT_PARAMS)
    plan = ops.plan_data_batched(x, params)
    kp = -(-K_PQ // params.block_k) * params.block_k
    cp, cn = ops._pad_centroids(seeds, K_PQ, kp, plan.xp.shape[2])
    tiles = dict(block_m=params.block_m, block_k=params.block_k,
                 block_f=params.block_f)
    b, np_, fp = plan.xp.shape
    nt = np_ // params.block_m
    xp, xn, c1, d2, bn = round_inputs(torch, kpp, hw, x)
    specs = [
        ("lloyd_step_batched", "src/repro/kernels/lloyd_step.py:278",
         lambda: ll.lloyd_step_batched(plan.xp, cp, cn, N_PQ, **tiles),
         lambda: ll.lloyd_step_batched_plain(plan.xp, cp, cn, N_PQ,
                                             params.block_m),
         lambda: torch.baddbmm(cn[:, None, :], plan.xp, cp.transpose(1, 2),
                               alpha=-2.0).min(dim=2),
         2.0 * b * N_PQ * K_PQ * F_PQ + b * N_PQ * F_PQ,
         4.0 * (b * N_PQ * F_PQ + b * K_PQ * F_PQ + b * K_PQ + 2 * b * N_PQ
                + b * nt * K_PQ * F_PQ + b * nt * K_PQ)),
        ("kmeanspp_round", "src/repro/kernels/kmeanspp_init.py:95",
         lambda: kpp.kmeanspp_round(xp, xn, c1, d2, block_n=bn),
         lambda: kpp.kmeanspp_round_plain(xp, xn, c1, d2, bn),
         lambda: torch.bmm(xp, c1.transpose(1, 2)),
         2.0 * b * xp.shape[1] * F_PQ + 5.0 * b * xp.shape[1],
         4.0 * (b * xp.shape[1] * (F_PQ + 3) + b * F_PQ
                + b * xp.shape[1] // bn)),
    ]
    rows = []
    for name, replaces, kfn, pfn, lfn, ops_n, bytes_n in specs:
        k_out, p_out = kfn(), pfn()
        err = max(max_err(a, b) for a, b in zip(k_out, p_out)
                  if a.is_floating_point())
        del k_out, p_out
        b_ms, b_by = bound(ops_n, bytes_n)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/fk_kernels.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": cuda_ms(kfn, reps=20),
                     "plain_ms": cuda_ms(pfn, reps=3),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": cuda_ms(lfn, reps=20)})
        torch.cuda.empty_cache()
    rec["f32_bound_share"] = {r["name"]: r["bound_ms"] / r["ms"]
                              for r in rows[:1]}
    rows.append(dense_tree_row(torch, up, ll, plan, cp, cn, tiles, bound,
                               tree_kinds["dense"]))
    # the bound counts the GEMM the problem needs (F = 16); the kernel
    # multiplies the features padded to Fp as well
    rec["gemm_flop"] = {"needed": 2.0 * b * N_PQ * K_PQ * F_PQ,
                        "padded": 2.0 * b * np_ * kp * fp}
    rec["lloyd_step_one_problem_ms"] = cuda_ms(
        lambda: ll.lloyd_step(plan.xp[0], cp[0], cn[0], N_PQ, **tiles),
        reps=20)
    rec["library_calls"] = {
        "lloyd_step_batched": "baddbmm(cn, X, C^T, alpha=-2) + min(dim=2): "
                              "the same distances and labels, no update",
        "kmeanspp_round": "bmm(X, c_last^T): the cross term alone"}
    return rec, rows


def safe_rows(torch, m: int, f: int, seed: int):
    """Quantisation-safe rows (``tests/test_int8.py``): integers in
    [-127, 127] with a +-127 pinned in every row, so every per-row scale is
    exactly 1.0 and quantising changes nothing."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, size=(m, f)).astype(np.float32)
    a[np.arange(m), rng.integers(0, f, m)] = 127.0
    return torch.from_numpy(a).cuda()


def phase_pruned_int8_kernels(torch, ops, ll, llp, dai) -> dict:
    """Phase 8: the pruned step and the int8 kernel against their plain
    versions on the card (TF32 off), and against the kernels they must
    equal bit for bit."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import update as up
    out = {"phase": 8, "shapes": []}
    for k in (1000, 100):
        params = ops.clamp_params(M_SMALL, k, F_SMALL, ops.DEFAULT_PARAMS)
        bm, bk = params.block_m, params.block_k
        tiles = dict(block_m=bm, block_k=bk, block_f=params.block_f)
        kp = -(-k // bk) * bk
        rec = {"k": k, "centroid_tiles": kp // bk, "tol_rel": 1e-5}
        rng = np.random.default_rng(SEED + k)

        def padded(x, c):
            plan = ops.plan_data(x, params)
            cp, cn = ops._pad_centroids(c, k, kp, plan.xp.shape[1])
            xn = F.pad(plan.xn, (0, plan.xp.shape[0] - plan.m)).contiguous()
            return plan, cp, cn, xn

        # a random mask on small integers: every product and sum is exact
        # in f32 in any order, so labels, sums and counts must be bitwise
        xi = rng.integers(-3, 4, size=(M_SMALL, F_SMALL)).astype(np.float32)
        ci = rng.integers(-3, 4, size=(k, F_SMALL)).astype(np.float32)
        plan, cp, cn, xn = padded(torch.from_numpy(xi).cuda(),
                                  torch.from_numpy(ci).cuda())
        nt = plan.xp.shape[0] // bm
        skip = torch.from_numpy((rng.random((nt, kp // bk)) < 0.5)
                                .astype(np.int32)).cuda()
        got = llp.lloyd_step_pruned(plan.xp, cp, cn, xn, skip, plan.m, **tiles)
        want = llp.lloyd_step_pruned_plain(plan.xp, cp, cn, xn, skip, plan.m,
                                           bm, bk)
        check_pruned_exact(torch, up, got, want, bm,
                           f"lloyd_step_pruned vs plain, random mask K={k}")
        ok, rec["pruned_random_min_err"] = rel_ok(got[0], want[0], 1e-5)
        expect(ok, f"lloyd_step_pruned min vs plain, random mask K={k}")
        ok, rec["pruned_random_tmin_err"] = rel_ok(got[5], want[4], 1e-5)
        expect(ok, f"lloyd_step_pruned tmin vs plain, random mask K={k}")
        rec["random_mask_skipped"] = float(skip.float().mean())
        del got, want

        # no skips on blob data: bit for bit lloyd_step
        x_np, _ = make_blobs(M_SMALL, F_SMALL, k, seed=SEED + k)
        x = torch.from_numpy(x_np).cuda()
        c = torch.from_numpy(blob_centers(k, F_SMALL, SEED + k)).cuda()
        plan, cp, cn, xn = padded(x, c)
        zero = torch.zeros_like(skip)
        got = llp.lloyd_step_pruned(plan.xp, cp, cn, xn, zero, plan.m, **tiles)
        one = ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)
        same_entries_step(torch, got, one,
                          f"lloyd_step_pruned without skips K={k}")
        want = llp.lloyd_step_pruned_plain(plan.xp, cp, cn, xn, zero, plan.m,
                                           bm, bk)
        ok, rec["pruned_tmin_err"] = rel_ok(got[5], want[4], 1e-5)
        expect(ok and bool(torch.equal(got[1], want[1])),
               f"lloyd_step_pruned tmin or labels vs plain, no skips K={k}")
        del got, one, want

        # int8 on float data: exact integer products on both sides, at
        # both row tiles
        qplan, cq, sc, cn8, _ = ops._resolve_padded_int8(x, c, params)
        rec["int8_min_err"] = check_int8_bitwise(
            torch, dai, qplan, cq, sc, cn8, bk, params.block_f, f"K={k}")
        # quantisation-safe data: bit for bit distance_argmin
        xs, cs = safe_rows(torch, M_SMALL, F_SMALL, SEED + k), \
            safe_rows(torch, k, F_SMALL, SEED + k + 1)
        am8, md8 = ops.fused_assign_int8(xs, cs, params)
        am32, md32 = ops.fused_assign(xs, cs, params)
        expect(bool(torch.equal(am8, am32)) and bool(torch.equal(md8, md32)),
               f"distance_argmin_int8 on safe data is not distance_argmin "
               f"K={k}")
        out["shapes"].append(rec)
        del x, plan, qplan, xs, cs
        torch.cuda.empty_cache()
    # the int8 kernel at more feature chunks: F 300 (Fp 320: X's row tile
    # stashed, three chunks, the last of 64) and F 1000 (Fp 1024: X's
    # chunks stream with C's, its row tile past the 48 KB stash)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    out["int8_wide"] = []
    for f in (F_WIDE, F_INT8_WIDE):
        k = 1000
        params = ops.clamp_params(M_SMALL, k, f, ops.DEFAULT_PARAMS)
        x = torch.randn(M_SMALL, f, generator=gen, device=DEV)
        c = torch.randn(k, f, generator=gen, device=DEV)
        qplan, cq, sc, cn8, _ = ops._resolve_padded_int8(x, c, params)
        out["int8_wide"].append({"f": f, "k": k, "fp": qplan.xq.shape[1],
                                 "min_err": check_int8_bitwise(
                                     torch, dai, qplan, cq, sc, cn8,
                                     params.block_k, params.block_f,
                                     f"F={f}")})
        del x, c, qplan, cq, sc, cn8
        torch.cuda.empty_cache()
    return out


def check_int8_bitwise(torch, dai, qplan, cq, sc, cn8, bk: int, bf: int,
                       what: str) -> float:
    """The int8 kernel at row tiles of 128 and 64 bit for bit its plain
    version; returns the largest |min - plain min| (0)."""
    want = dai.distance_argmin_int8_plain(qplan.xq, cq, qplan.sx, sc, cn8)
    err = 0.0
    for bm in (128, 64):
        got = dai.distance_argmin_int8(qplan.xq, cq, qplan.sx, sc, cn8,
                                       block_m=bm, block_k=bk, block_f=bf)
        err = max(err, max_err(got[0], want[0]))
        expect(bool(torch.equal(got[0], want[0]))
               and bool(torch.equal(got[1], want[1])),
               f"distance_argmin_int8 (BM {bm}) vs plain is not bitwise "
               f"{what}")
    return err


def phase_pruned_int8_fits(torch, ops, hw, llp, dai, KMeans, x, labels_true,
                           c_init, km_ll, km_off, lib_ms,
                           bound) -> tuple[dict, list]:
    """Phase 9: the pruned and int8 paths at the phase-3 shape, then the
    rows of their kernels."""
    import torch.nn.functional as F
    from repro_torch.core.kmeans import means_from_sums
    base = dict(n_clusters=K_FULL, max_iter=ITERS, tol=0.0, random_state=SEED)
    from repro_torch.kernels import update as up
    wrappers = {"lloyd_step_pruned": llp.lloyd_step_pruned,
                "distance_argmin_int8": dai.distance_argmin_int8,
                "update_entries": up.update_entries,
                "tree_reduce": up.tree_reduce}
    for w in wrappers.values():
        w.launches = 0
    up.tree_reduce.kernel_launches.update(sparse=0, dense=0)
    # (a) rows in random order: little to prune, the bookkeeping's cost
    km_pr, pr_s = wall(lambda: KMeans(backend="lloyd_pruned", **base)
                       .fit(x, centroids=c_init))
    _, ll_s = wall(lambda: KMeans(backend="lloyd", **base)
                   .fit(x, centroids=c_init))
    expect(bool(torch.equal(km_pr.cluster_centers_, km_ll.cluster_centers_))
           and bool(torch.equal(km_pr.labels_, km_ll.labels_)),
           "lloyd_pruned fit is not bit for bit the lloyd fit (random order)")
    # (b) rows sorted by generating label, seeded by each label's first
    # row: centroid tiles aligned with row tiles
    order = torch.argsort(labels_true, stable=True)
    xs, lab = x[order].contiguous(), labels_true[order]
    first = torch.searchsorted(lab, torch.arange(K_FULL, device=lab.device,
                                                 dtype=lab.dtype))
    expect(bool((lab[first] == torch.arange(K_FULL, device=lab.device)).all()),
           "a generating label has no row")
    seeds = xs[first]
    km_apr, apr_s = wall(lambda: KMeans(backend="lloyd_pruned", **base)
                         .fit(xs, centroids=seeds))
    km_all, all_s = wall(lambda: KMeans(backend="lloyd", **base)
                         .fit(xs, centroids=seeds))
    expect(bool(torch.equal(km_apr.cluster_centers_, km_all.cluster_centers_))
           and bool(torch.equal(km_apr.labels_, km_all.labels_)),
           "lloyd_pruned fit is not bit for bit the lloyd fit (sorted rows)")
    hist = km_apr.prune_history_
    third = hist[-max(1, len(hist) // 3):]
    expect(len(hist) == km_apr.n_iter_ and hist[0] == 0.0
           and min(third) >= 0.5,
           f"aligned pruning below 50 % in the last third: {hist}")
    expect(km_apr._n_host_syncs == km_all._n_host_syncs,
           "the pruned fit reads the host more often than the lloyd fit")
    # (c) the int8 fit, predict and score. From c_init (k-means++ seeds,
    # blobs without a seed are split on margins the quantisation moves) the
    # int8 and f32 fits converge to different optima; the reference's own
    # int8 fit leaves its f32 fit alike on such data
    # (tests/test_torch_int8.py::test_int8_leaves_f32_alike_in_both_packages).
    # So the reference's 5 % bar is held two ways: the exact (f32) inertia
    # of the int8 fit's centroids is at most 5 % above the fused fit's, and
    # from the blob centres, where both fits share their optimum, the int8
    # fit's inertia is within 5 % of the fused fit's.
    km8, i8_s = wall(lambda: KMeans(compute_dtype="int8", **base)
                     .fit(x, centroids=c_init))
    labels8 = km8.predict(x)
    score8 = km8.score(x)
    centres = torch.from_numpy(blob_centers(K_FULL, F_FULL, SEED)).cuda()
    c8 = KMeans(compute_dtype="int8", **base).fit(x, centroids=centres)
    cf = KMeans(**base).fit(x, centroids=centres)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    tree_kinds = dict(up.tree_reduce.kernel_launches)
    for name, n in launches.items():
        expect(n > 0, f"{name} was not launched on its path")
    xn = (x * x).sum(1)

    def exact_inertia(c):
        return float((ops.fused_assign(x, c)[1] + xn).sum())
    exact8 = exact_inertia(km8.cluster_centers_)
    exact_f = exact_inertia(km_off.cluster_centers_)
    rel8 = abs(km8.inertia_ - km_off.inertia_) / km_off.inertia_
    rel_centres = abs(c8.inertia_ - cf.inertia_) / cf.inertia_
    expect(km8._backend.name == "int8"
           and exact8 <= (1.0 + INT8_INERTIA_RTOL) * exact_f,
           f"int8 fit's exact inertia {exact8} over 1.05 x fused {exact_f}")
    expect(rel_centres <= INT8_INERTIA_RTOL
           and bool(torch.equal(c8.labels_, cf.labels_)),
           f"int8 fit from the blob centres: inertia {rel_centres:.4f} from "
           f"the fused fit's, or other labels")
    expect(km8.cluster_centers_.dtype == torch.float32
           and bool(torch.isfinite(km8.cluster_centers_).all()),
           "int8 centroids are not finite f32")
    expect(labels8.shape == (M_FULL,) and int(labels8.min()) >= 0
           and int(labels8.max()) < K_FULL and score8 < 0,
           f"int8 predict/score out of range ({score8})")
    # the same readings from other k-means++ seeds (after the launch
    # counts): how far, and to which side, the int8 fit's optimum lies
    sweep = [{"seed": SEED, "int8_exact_inertia": exact8,
              "fused_exact_inertia": exact_f}]
    for s in INT8_SWEEP_SEEDS:
        c_s = KMeans(**dict(base, random_state=s)).init_centroids(x)
        sweep.append({"seed": s, "int8_exact_inertia": exact_inertia(
            KMeans(compute_dtype="int8", **base).fit(
                x, centroids=c_s).cluster_centers_),
            "fused_exact_inertia": exact_inertia(KMeans(**base).fit(
                x, centroids=c_s).cluster_centers_)})
    for r in sweep:
        r["rel"] = r["int8_exact_inertia"] / r["fused_exact_inertia"] - 1.0
        expect(math.isfinite(r["rel"]), f"int8 seed sweep not finite: {r}")
    rec = {"phase": 9, "m": M_FULL, "f": F_FULL, "k": K_FULL,
           "random_order": {"lloyd_pruned_ms_per_iter": 1e3 * pr_s / ITERS,
                            "lloyd_ms_per_iter": 1e3 * ll_s / ITERS,
                            "prune_history": km_pr.prune_history_},
           "label_sorted": {"lloyd_pruned_ms_per_iter": 1e3 * apr_s / ITERS,
                            "lloyd_ms_per_iter": 1e3 * all_s / ITERS,
                            "prune_history": hist},
           "int8_ms_per_iter": 1e3 * i8_s / km8.n_iter_,
           "int8_inertia": km8.inertia_, "fused_inertia": km_off.inertia_,
           "int8_inertia_rel_to_fused": rel8,
           "int8_exact_inertia": exact8, "fused_exact_inertia": exact_f,
           "from_centres_inertia_rel": rel_centres, "int8_score": score8,
           "int8_seed_sweep": sweep,
           "n_host_syncs": {"lloyd_pruned": km_apr._n_host_syncs,
                            "lloyd": km_all._n_host_syncs},
           "launches": launches, "tree_reduce_variants": tree_kinds}
    del km_pr, km_all, km8, labels8, c8, cf, xn
    torch.cuda.empty_cache()

    # the pruned kernel's row: the inputs of the sorted fit's third step
    params = ops.clamp_params(M_FULL, K_FULL, F_FULL, ops.DEFAULT_PARAMS)
    bm, bk = params.block_m, params.block_k
    tiles = dict(block_m=bm, block_k=bk, block_f=params.block_f)
    plan = ops.plan_data(xs, params)
    c, bounds = seeds, None
    for _ in range(2):
        _, _, sums, counts, bounds, _ = ops.fused_lloyd_pruned(
            plan, c, params, bounds=bounds)
        c = means_from_sums(sums, counts, c)
    kp = -(-K_FULL // bk) * bk
    cp, cn = ops._pad_centroids(c, K_FULL, kp, plan.xp.shape[1])
    skip, _ = ops.prune_mask(bounds, cp, plan.m, params)
    skip = skip.contiguous()
    mp, fp = plan.xp.shape
    nt, nkt = mp // bm, kp // bk
    xn = F.pad(plan.xn, (0, mp - plan.m)).contiguous()
    computed = int((skip == 0).sum())
    rec["pruned_row_skipped"] = 1.0 - computed / (nt * nkt)
    # the computed cells' true rows x columns (the last centroid tile holds
    # K - 7 * 128 = 104 of its 128)
    ar = torch.arange(max(nt, nkt), device=skip.device)
    rows_in = (plan.m - ar[:nt] * bm).clamp(max=bm)
    cols_in = (K_FULL - ar[:nkt] * bk).clamp(max=bk)
    cells = float(((skip == 0) * rows_in[:, None] * cols_in[None, :]).sum())

    def pruned():
        return llp.lloyd_step_pruned(plan.xp, cp, cn, xn, skip, plan.m,
                                     **tiles)

    def pruned_plain():
        return llp.lloyd_step_pruned_plain(plan.xp, cp, cn, xn, skip, plan.m,
                                           bm, bk)
    k_out, p_out = pruned(), pruned_plain()
    n_present = int((k_out[4] >= 0).sum())
    k_out, p_out = pruned_canon(up, k_out, bm), pruned_canon(up, p_out, bm)
    expect(bool(torch.equal(k_out[1], p_out[1]))
           and bool(torch.equal(k_out[3], p_out[3])),
           "lloyd_step_pruned labels or counts vs plain at the phase-3 shape")
    pr_err = max(max_err(a, b) for a, b in zip(k_out, p_out)
                 if a.is_floating_point())
    del k_out, p_out
    torch.cuda.empty_cache()
    # the step's memory past X (the first design wrote 4.33 GB of dense
    # partials here), the tree over its entries, and lloyd_step on the same
    # inputs beside the no-skip step
    from repro_torch.kernels import lloyd_step as ll
    rec["pruned_step_peak_gb_past_x"] = peak_gb(pruned)
    out = pruned()
    rec["pruned_tree_over_entries_ms"] = cuda_ms(
        lambda: up.reduce_entries(out[2], out[3], out[4], ntiles=nt))
    rec["pruned_present_entries"] = n_present
    del out
    rec["lloyd_step_pruned_no_skip_ms"] = cuda_ms(
        lambda: llp.lloyd_step_pruned(plan.xp, cp, cn, xn,
                                      torch.zeros_like(skip), plan.m,
                                      **tiles))
    rec["lloyd_step_same_inputs_ms"] = cuda_ms(
        lambda: ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles))
    m_f = float(M_FULL * F_FULL)
    # the computed cells' GEMM against X read once, C, the labels and
    # distances, the rows' norms, the entries and idx, the mask and bounds
    b_ms, b_by = bound(2.0 * cells * F_FULL + m_f,
                       4.0 * m_f + 4.0 * K_FULL * F_FULL + 12.0 * M_FULL
                       + entry_bytes(n_present, F_FULL, K_FULL, nt)
                       + 8.0 * nt * nkt)
    rec["bound_padded_ms"] = {"lloyd_step_pruned": bound(
        2.0 * computed * bm * bk * fp + mp * fp,
        4.0 * mp * fp + 4.0 * kp * fp + 12.0 * mp
        + entry_bytes(n_present, fp, kp, nt) + 8.0 * nt * nkt)[0]}
    rows = [{"name": "lloyd_step_pruned", "route": "cuda",
             "source": "src/repro_torch/csrc/fk_kernels.cu",
             "replaces": "src/repro/kernels/lloyd_step_pruned.py:189",
             "launches": launches["lloyd_step_pruned"], "max_abs_err": pr_err,
             "ms": cuda_ms(pruned), "plain_ms": cuda_ms(pruned_plain, reps=2),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}]
    del plan, xs, bounds, sums, counts
    torch.cuda.empty_cache()

    # the int8 kernel's row: the int8 fit's first step
    qplan, cq, sc, cn8, _ = ops._resolve_padded_int8(x, c_init, params)

    def int8():
        return dai.distance_argmin_int8(qplan.xq, cq, qplan.sx, sc, cn8,
                                        **tiles)

    def int8_plain():
        return dai.distance_argmin_int8_plain(qplan.xq, cq, qplan.sx, sc, cn8)

    def int8_library():
        acc = torch._int_mm(qplan.xq, cq.T)
        return (cn8[None, :] - 2.0 * (qplan.sx[:, None]
                                      * (acc.float() * sc[None, :]))).min(1)
    k_out, p_out = int8(), int8_plain()
    expect(bool(torch.equal(k_out[0], p_out[0]))
           and bool(torch.equal(k_out[1], p_out[1])),
           "distance_argmin_int8 vs plain is not bitwise at the phase-3 shape")
    i8_err = max_err(k_out[0], p_out[0])
    del k_out, p_out
    torch.cuda.empty_cache()
    b_ms, b_by = bound(2.0 * m_f * K_FULL,
                       m_f + 12.0 * M_FULL + K_FULL * F_FULL + 8.0 * K_FULL,
                       peak=hw.PEAK_OPS_INT8)
    rec["bound_padded_ms"]["distance_argmin_int8"] = bound(
        2.0 * mp * kp * fp, mp * fp + 12.0 * mp + kp * fp + 8.0 * kp,
        peak=hw.PEAK_OPS_INT8)[0]
    i8_ms = cuda_ms(int8, reps=20)
    rec["int8_bound_share"] = b_ms / i8_ms
    rows.append({"name": "distance_argmin_int8", "route": "cuda",
                 "source": "src/repro_torch/csrc/fk_kernels.cu",
                 "replaces": "src/repro/kernels/distance_argmin_int8.py:123",
                 "launches": launches["distance_argmin_int8"],
                 "max_abs_err": i8_err, "ms": i8_ms,
                 "plain_ms": cuda_ms(int8_plain, reps=2),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": cuda_ms(int8_library)})
    rec["library_calls"] = {
        "lloyd_step_pruned": "addmm(cn, X, C^T, alpha=-2) + min(dim=1) at "
                             "the phase-5 inputs (as rows 1-2): every tile",
        "distance_argmin_int8": "_int_mm(Xq, Cq^T) + scale correction + "
                                "min(dim=1)"}
    return rec, rows


def phase_detect(torch, ops, hw, ll, mma, cud, KMeans, FaultPolicy,
                 InjectionCampaign, x, c_init, km_off, km_ft, off_ms, ft_ms,
                 bound) -> tuple[dict, list]:
    """Phase 10: ``FaultPolicy.detect()`` (offline ABFT) fits at the phase-3
    shape, then the ABFT GEMM (``ops.abft_matmul``) at the detect fit's
    product and at an LM FFN up-projection, and the DMR update
    (``centroid_update_dmr``) on the fused fit's labels: the path's launches,
    each kernel against its plain version, and the rows of both kernels."""
    from repro_torch.core import checksum
    from repro_torch.core.ft_gemm import ft_matmul
    base = dict(n_clusters=K_FULL, max_iter=ITERS, tol=0.0, random_state=SEED)
    from repro_torch.kernels import update as up
    wrappers = {"matmul_abft": mma.matmul_abft,
                "abft_encodings": mma.abft_encodings,
                "centroid_update_dmr": cud.centroid_update_dmr,
                "update_entries": up.update_entries,
                "tree_reduce": up.tree_reduce}
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the LM shape: internlm2-1.8b's FFN up-projection, 4 x 2048 tokens
    xb = torch.randn(LM_TOKENS, LM_D_MODEL, generator=gen, device=dev)
    wb = torch.randn(LM_D_MODEL, LM_D_FF, generator=gen,
                     device=dev) / math.sqrt(LM_D_MODEL)
    labels_off = km_off.labels_
    for w in wrappers.values():
        w.launches = 0
    # --- the path: detect fit, predict, score, a detect campaign, the ABFT
    # GEMM at both shapes (clean and with a planted fault), the DMR update
    # (clean and with its debug shadow fault)
    km_det, det_s = wall(lambda: KMeans(fault=FaultPolicy.detect(), **base)
                         .fit(x, centroids=c_init))
    det_labels = km_det.predict(x)
    det_score = km_det.score(x)
    camp = FaultPolicy.detect(injection=InjectionCampaign(rate=1.0))
    km_camp, camp_s = wall(lambda: KMeans(fault=camp, **base)
                           .fit(x, centroids=c_init))
    ya = km_det.cluster_centers_.T.contiguous()
    shapes = {"a": (x, ya), "b": (xb, wb)}
    gemm_out = {}
    for key, (xg, yg) in shapes.items():
        m, k = xg.shape
        n = yg.shape[1]
        bm, bn, bk = ops.abft_tiles(m, n, k)
        tiles = (-(-m // bm), -(-n // bn), -(-k // bk))
        # a fault of 5e4 in a middle tile, after a middle k-step (the only
        # one at K = 128)
        inj = mma.make_injection(tiles[0] // 2, tiles[1] // 2, tiles[2] // 2,
                                 7, 31, 5e4).cuda()
        d, det = ops.abft_matmul(xg, yg)
        d_f, det_f = ops.abft_matmul(xg, yg, inj=inj)
        gemm_out[key] = (d, det, d_f, det_f, inj, (bm, bn, bk), tiles)
    sums, counts, bad = cud.centroid_update_dmr(x, labels_off, K_FULL)
    _, _, bad_f = cud.centroid_update_dmr(x, labels_off, K_FULL,
                                          shadow_fault=SHADOW_FAULT)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, n in launches.items():
        expect(n > 0, f"{name} was not launched on the detect path")

    # --- the fits
    expect(km_det._backend.name == "abft_offline"
           and km_camp._backend.name == "lloyd_ft",
           f"detect resolved to {km_det._backend.name}, its campaign to "
           f"{km_camp._backend.name}")
    agree = float((km_det.labels_ == labels_off).float().mean())
    inertia_rel = abs(km_det.inertia_ - km_off.inertia_) / km_off.inertia_
    expect(agree >= DETECT_LABEL_AGREEMENT,
           f"detect fit labels agree with the fused fit on {agree:.6f}")
    expect(inertia_rel <= DETECT_INERTIA_RTOL,
           f"detect fit inertia {km_det.inertia_} vs fused "
           f"{km_off.inertia_} (rel {inertia_rel:.3e})")
    expect(bool(torch.isfinite(km_det.cluster_centers_).all())
           and det_labels.shape == (M_FULL,) and int(det_labels.min()) >= 0
           and int(det_labels.max()) < K_FULL and det_score < 0,
           f"detect predict/score out of range ({det_score})")
    expect(km_camp.detected_errors_ > 0, "detect campaign detected nothing")
    expect(bool(torch.equal(km_camp.cluster_centers_,
                            km_ft.cluster_centers_)),
           "detect campaign centroids are not bitwise the clean lloyd_ft "
           "fit's")
    # the clean product's checksum residuals against ft_matmul's threshold
    # (scale max|D|); columns sum over all M rows
    da = x @ ya
    exp = checksum.expected_checksums(x, ya)
    obs = checksum.observed_checksums(da)
    thr = checksum.default_threshold(F_FULL) * max(
        float(da.abs().max()), 1.0)
    margin = {"col": float((obs.col1 - exp.col1).abs().max()) / thr,
              "row": float((obs.row1 - exp.row1).abs().max()) / thr}
    del da, exp, obs
    torch.cuda.empty_cache()
    rec = {"phase": 10, "m": M_FULL, "f": F_FULL, "k": K_FULL,
           "detect_ms_per_iter": 1e3 * det_s / km_det.n_iter_,
           "fused_ms_per_iter": off_ms, "lloyd_ft_ms_per_iter": ft_ms,
           "detect_over_fused": 1e3 * det_s / km_det.n_iter_ / off_ms,
           "detect_over_lloyd_ft": 1e3 * det_s / km_det.n_iter_ / ft_ms,
           "detected_errors": km_det.detected_errors_,
           "label_agreement_with_fused": agree,
           "inertia": km_det.inertia_, "fused_inertia": km_off.inertia_,
           "inertia_rel": inertia_rel, "score": det_score,
           "clean_residual_over_threshold": margin,
           "campaign_detected": km_camp.detected_errors_,
           "campaign_ms_per_iter": 1e3 * camp_s / km_camp.n_iter_,
           "n_host_syncs": km_det._n_host_syncs, "launches": launches}
    del km_det, km_camp, det_labels
    torch.cuda.empty_cache()

    # --- the ABFT GEMM against its plain version, then its times; the
    # yardstick is torch.matmul in full f32 (main pins TF32 off)
    rows = []
    no_inj = mma.no_injection().cuda()
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    expect(not allow_tf32, "torch.matmul's TF32 is on: the f32 yardstick "
           "must run in full f32")
    for key, (xg, yg) in shapes.items():
        d, det, d_f, det_f, inj, (bm, bn, bk), tiles = gemm_out[key]
        m, k = xg.shape
        n = yg.shape[1]
        mp, np_, kp = tiles[0] * bm, tiles[1] * bn, tiles[2] * bk
        xp = ops._pad_to(xg, mp, kp)
        yp = ops._pad_to(yg, kp, np_)
        factor = ops.threshold_factor(kp, torch.float32)
        pd, pdet = mma.matmul_abft_plain(xp, yp, no_inj, bm, bn, bk, factor)
        pd = pd[:m, :n]
        ok, err = rel_ok(d, pd, 1e-5)
        expect(int(det) == 0 and int(pdet.sum()) == 0 and ok,
               f"abft_matmul ({key}) clean: det {int(det)}, plain det "
               f"{int(pdet.sum())}, err {err}")
        fix_err = float(((d_f - pd).abs() - 2e-4 * pd.abs()).max())
        expect(int(det_f) == 1 and fix_err <= 2e-2,
               f"abft_matmul ({key}) with a 5e4 fault: det {int(det_f)}, "
               f"corrected D off the plain product by {fix_err} over "
               f"rtol 2e-4")
        del d, d_f, pd, pdet
        gemm_out[key] = None
        torch.cuda.empty_cache()

        def kern():
            return mma.matmul_abft(xp, yp, no_inj, block_m=bm, block_n=bn,
                                   block_k=bk, factor=factor)

        def plain():
            return mma.matmul_abft_plain(xp, yp, no_inj, bm, bn, bk, factor)

        def run(f):
            return int(mma.matmul_abft(xp, yp, no_inj, block_m=bm,
                                       block_n=bn, block_k=bk,
                                       factor=f)[1].sum())
        # the kernel's own clean-residual margin: log2 of the threshold over
        # the largest clean residual of any tile lies in [lo, hi); lo > 0:
        # no tile of the clean product is flagged
        margin = clean_margin_log2(run, factor)
        expect(margin[0] > 0.0, f"abft_matmul ({key}): a tile of the clean "
               f"product is flagged (margin log2 {margin})")
        # the bound: the six bf16 products of the split on the tensor
        # cores, or the bytes of f32 X, Y and D; the f32 product on the
        # CUDA cores beside it
        flops = 2.0 * m * n * k
        nbytes = 4.0 * (m * k + k * n + m * n)
        b_ms, b_by = bound(6.0 * flops, nbytes, peak=hw.PEAK_FLOPS_BF16)
        # the encodings pre-pass: f32 X and Y read once, E_X and E_Y out,
        # Y's three bf16 planes written, then the expected column and row
        # checksums E_X Y and X E_Y (4 (m-tiles) k n + 4 m k (n-tiles) FLOPs
        # on the CUDA cores, written as pairs)
        kpe = -(-kp // mma.ENC_K_ALIGN) * mma.ENC_K_ALIGN
        nmt, nnt = mp // bm, np_ // bn
        e_ms, e_by = bound(4.0 * (m + n) * k + 4.0 * (nmt * n + m * nnt) * k,
                           4.0 * (m * k + k * n)
                           + 8.0 * (nmt + nnt) * kpe + 6.0 * k * n
                           + 8.0 * (nmt * n + m * nnt))
        ex_k, ey_k, planes_k, ecol_k, erow_k = mma.abft_encodings(
            xp, yp, block_m=bm, block_n=bn)
        ex_p, ey_p, planes_p, ecol_p, erow_p = mma.abft_operands_plain(
            xp, yp, bm, bn)
        pairs = ((ex_k, ex_p), (ey_k, ey_p), (ecol_k, ecol_p),
                 (erow_k, erow_p))
        enc_abs = max(max_err(a_, b_) for a_, b_ in pairs)
        enc_rel = max(max_err(a_, b_) / max(float(b_.abs().max()), 1.0)
                      for a_, b_ in pairs)
        planes_ok = bool(torch.equal(planes_k, planes_p))
        expect(enc_rel <= 1e-5 and planes_ok,
               f"abft_encodings ({key}) f32: E_X, E_Y and the expected "
               f"checksums off their plain version by {enc_rel} "
               f"(normalised), Y's planes bitwise: {planes_ok}")
        del ex_k, ey_k, planes_k, ecol_k, erow_k, ex_p, ey_p, planes_p
        del ecol_p, erow_p, pairs
        t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, reps=2),
             "library_ms": cuda_ms(lambda: torch.matmul(xg, yg)),
             "library_allow_tf32": allow_tf32,
             "ft_matmul_ms": cuda_ms(lambda: ft_matmul(xg, yg), reps=3),
             "bound_ms": b_ms, "bound_by": b_by,
             "bound_f32_cuda_core_ms": bound(flops, nbytes)[0],
             "bound_padded_ms": bound(12.0 * mp * np_ * kp,
                                      4.0 * (mp * kp + kp * np_
                                             + mp * np_),
                                      peak=hw.PEAK_FLOPS_BF16)[0],
             "encode_ms": cuda_ms(lambda: mma.abft_encodings(
                 xp, yp, block_m=bm, block_n=bn)),
             "encode_plain_ms": cuda_ms(lambda: mma.abft_operands_plain(
                 xp, yp, bm, bn), reps=2),
             "encode_bound_ms": e_ms, "encode_bound_by": e_by,
             "encodings_max_abs_err": enc_abs,
             "clean_margin_log2": margin,
             "tiles": [bm, bn, bk], "max_abs_err": err,
             "fault_tile": [int(v) for v in inj[1:6].tolist()],
             "corrected_err_over_rtol": fix_err}
        rec[f"abft_matmul_{key}"] = t
        if key == "a":
            rows.append({"name": "matmul_abft", "route": "cuda",
                         "source": "src/repro_torch/csrc/fk_abft_gemm.cu",
                         "replaces": "src/repro/kernels/matmul_abft.py:127",
                         "launches": launches["matmul_abft"],
                         "max_abs_err": err, "ms": t["ms"],
                         "plain_ms": t["plain_ms"], "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": t["library_ms"]})
            rows.append({"name": "abft_encode", "route": "cuda",
                         "source": "src/repro_torch/csrc/fk_abft_gemm.cu",
                         "replaces": "src/repro/kernels/matmul_abft.py:127",
                         "launches": launches["abft_encodings"],
                         "max_abs_err": enc_abs, "ms": t["encode_ms"],
                         "plain_ms": t["encode_plain_ms"],
                         "bound_ms": e_ms, "bound_by": e_by,
                         "library_ms": None})
        del xp, yp
        torch.cuda.empty_cache()
    del xb, wb, ya
    torch.cuda.empty_cache()
    # the f32 GEMM at the tiles its kernel treats apart
    rec["abft_tiles"] = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    for tiles, (m, k, n) in ABFT_TILE_CASES:
        xg = torch.randn(m, k, generator=gen, device=dev)
        yg = torch.randn(k, n, generator=gen, device=dev)
        rec["abft_tiles"].append(dict(
            m=m, k=k, n=n, **abft_checks(torch, ops, mma, xg, yg,
                                         torch.float32, under=True,
                                         tiles=tiles)))
        del xg, yg
        torch.cuda.empty_cache()

    # --- the DMR update against its plain version, then its times
    ps, pc, pbad = cud.centroid_update_dmr_plain(x, labels_off, K_FULL,
                                                 hw.DMR_BLOCK_M)
    _, _, pbad_f = cud.centroid_update_dmr_plain(
        x, labels_off, K_FULL, hw.DMR_BLOCK_M, shadow_fault=SHADOW_FAULT)
    ok, dmr_err = rel_ok(sums, ps, 1e-5)
    expect(ok and bool(torch.equal(counts, pc)) and int(bad) == 0
           and int(pbad) == 0,
           f"centroid_update_dmr vs plain: err {dmr_err}, counts equal "
           f"{bool(torch.equal(counts, pc))}, bad {int(bad)}/{int(pbad)}")
    expect(int(bad_f) == 1 and int(pbad_f) == 1,
           f"a corrupted shadow partial was not flagged ({int(bad_f)}, "
           f"{int(pbad_f)})")
    del ps, pc, sums, counts
    torch.cuda.empty_cache()
    dmr_cases, dmr_case_ms = dmr_checks(torch, cud, hw, x, labels_off)
    lab_long = labels_off.long()

    def library():
        return (torch.zeros(K_FULL, F_FULL, device=dev).index_add_(
                    0, lab_long, x),
                torch.bincount(lab_long, minlength=K_FULL))

    def library_dmr():
        # a DMR update's work by library calls: two updates, then their
        # compare into a verdict left on the card (index_add_'s float
        # atomics add in no fixed order, so this verdict would also flag
        # clean runs: it is a yardstick of time, not a DMR)
        (s1, n1), (s2, n2) = library(), library()
        return (s1 != s2).any() | (n1 != n2).any()
    params = ops.clamp_params(M_FULL, K_FULL, F_FULL, ops.DEFAULT_PARAMS)
    plan = ops.plan_data(x, params)
    m_f = float(M_FULL * F_FULL)
    b_ms, b_by = bound(2.0 * m_f, 4.0 * m_f + 4.0 * M_FULL
                       + 4.0 * K_FULL * (F_FULL + 1) + 4.0)
    dmr = {"ms": cuda_ms(lambda: cud.centroid_update_dmr(x, labels_off,
                                                         K_FULL), reps=10),
           "plain_ms": cuda_ms(lambda: cud.centroid_update_dmr_plain(
               x, labels_off, K_FULL, hw.DMR_BLOCK_M), reps=2),
           "library_ms": cuda_ms(library_dmr, reps=10),
           "library_one_update_ms": cuda_ms(library, reps=10),
           "tiled_update_dmr_ms": cuda_ms(lambda: ops.tiled_update(
               plan, labels_off, K_FULL, use_dmr=True), reps=3),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": dmr_err,
           "cases": dmr_cases, **dmr_case_ms}
    rec["centroid_update_dmr"] = dmr
    rec["library_calls"] = {
        "matmul_abft": "torch.matmul(X, Y) in full f32 (allow_tf32 False): "
                       "the unprotected product",
        "centroid_update_dmr": "two index_add_(0, labels, X) + bincount "
                               "updates and their compare: a DMR "
                               "update's work (library_one_update_ms: "
                               "one update)"}
    rows.append({"name": "centroid_update_dmr", "route": "cuda",
                 "source": "src/repro_torch/csrc/fk_kernels.cu",
                 "replaces": "src/repro/kernels/centroid_update_dmr.py:72",
                 "launches": launches["centroid_update_dmr"],
                 "max_abs_err": dmr_err, "ms": dmr["ms"],
                 "plain_ms": dmr["plain_ms"], "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": dmr["library_ms"]})
    del plan
    torch.cuda.empty_cache()
    return rec, rows


def dmr_checks(torch, cud, hw, x, labels) -> tuple[dict, dict]:
    """The DMR update kernel's cases on the card, each against its plain
    version (sums within rtol 1e-5 of the largest, counts equal, clean
    verdicts), against ``dmr_walk_plain`` (the walk's order of adds: sums,
    counts and verdict bit for bit) and against a second launch (bit for
    bit): at K = 1000 the fused fit's labels, every row in one cluster,
    half of them in one, a short last slab (M not a multiple of the slab)
    and labels -1 and >= K; phase 2's M and F = 100; K = 5000 at F = 16;
    then ``SHADOW_FAULT``, which must flag, beside a
    fault a quarter of the threshold, which must not. Returns (the cases'
    record, the skewed cases' times)."""
    dev = x.device
    m, k = x.shape[0], K_FULL
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    half = labels.clone()
    half[torch.rand(m, generator=gen, device=dev) < 0.5] = 7
    outside = labels.clone()
    r = torch.rand(m, generator=gen, device=dev)
    outside[r < 0.1] = -1
    outside[(r >= 0.1) & (r < 0.15)] = k + 3
    ragged = m - 12_345
    one = torch.full_like(labels, 3)
    # phase 2's M and F = 100 (a feature a lane, 4-byte loads; a second
    # slab of 37 rows), and K = 5000 (the bucketing's chunks grow to keep
    # its histogram small)
    x100 = torch.randn(M_SMALL, F_SMALL, generator=gen, device=dev)
    x16 = torch.randn(200_000, 16, generator=gen, device=dev)
    cases = {"fused_labels": (x, labels, k), "one_cluster": (x, one, k),
             "half_in_one": (x, half, k),
             "ragged_last_slab": (x[:ragged], labels[:ragged], k),
             "labels_outside_0_k": (x, outside, k),
             "f100": (x100, labels[:M_SMALL], k),
             "k5000_f16": (x16, torch.randint(
                 0, 5000, (200_000,), generator=gen, device=dev,
                 dtype=labels.dtype), 5000)}
    rec = {}
    for name, (xc, ac, kc) in cases.items():
        s1, c1, b1 = cud.centroid_update_dmr(xc, ac, kc)
        s2, c2, b2 = cud.centroid_update_dmr(xc, ac, kc)
        ws, wc, wb = cud.dmr_walk_plain(xc, ac, kc, hw.DMR_BLOCK_M)
        ps, pc, pb = cud.centroid_update_dmr_plain(xc, ac, kc,
                                                   hw.DMR_BLOCK_M)
        ok, err = rel_ok(s1, ps, 1e-5)
        repeat = bool(torch.equal(s1, s2) and torch.equal(c1, c2)
                      and int(b1) == int(b2))
        walk = bool(torch.equal(s1, ws) and torch.equal(c1, wc)
                    and int(b1) == int(wb))
        counts_ok = bool(torch.equal(c1, pc))
        expect(ok and counts_ok and int(b1) == 0 and int(pb) == 0
               and repeat and walk,
               f"centroid_update_dmr ({name}): err {err}, counts equal "
               f"{counts_ok}, bad {int(b1)}/{int(pb)}, two launches bitwise "
               f"{repeat}, the walk's bits {walk}")
        rec[name] = {"shape": [*xc.shape, kc], "max_abs_err": err,
                     "counts_equal": counts_ok, "repeat_bitwise": repeat,
                     "walk_bitwise": walk}
        del s1, c1, s2, c2, ws, wc, ps, pc
        torch.cuda.empty_cache()
    del x100, x16
    sums = cud.centroid_update_dmr(x, labels, k)[0]
    under = (SHADOW_FAULT[0], SHADOW_FAULT[1], SHADOW_FAULT[2],
             0.25e-4 * max(float(sums.abs().max()), 1.0))
    flags = {}
    for name, fault in (("shadow_fault", SHADOW_FAULT),
                        ("under_threshold", under)):
        flags[name] = (int(cud.centroid_update_dmr(
            x, labels, k, shadow_fault=fault)[2]), int(
            cud.centroid_update_dmr_plain(x, labels, k, hw.DMR_BLOCK_M,
                                          shadow_fault=fault)[2]))
    expect(flags["shadow_fault"] == (1, 1)
           and flags["under_threshold"] == (0, 0),
           f"centroid_update_dmr faults (kernel, plain): {flags}, the "
           f"second {under[3]} under a threshold of {4 * under[3]}")
    rec["fault_flags_kernel_plain"] = flags
    times = {f"{name}_ms": cuda_ms(lambda: cud.centroid_update_dmr(
        x, a, k), reps=10) for name, a in (("one_cluster", one),
                                            ("half_in_one", half))}
    return rec, times


def decode_plan(fa, b, h, kvh, sq, skv, hd, dtype) -> dict:
    """The decode kernel's KV splits and rows a block for these shapes on
    this card (``fk_flash_workspace``)."""
    import ctypes
    from repro_torch.kernels import _build
    got = (ctypes.c_longlong * 4)()
    code = _build.library("fk_attention").lib.fk_flash_workspace(
        b, h, kvh, sq, skv, hd, fa._DTYPES[dtype], ctypes.addressof(got))
    expect(code == 0, f"fk_flash_workspace failed ({code})")
    return {"splits": int(got[2]), "rows_a_block": int(got[3]),
            "partial_mbytes": 4e-6 * int(got[0])}


def tile_shares(fa, qpos, kpos, block_q, block_k, causal=True, window=0):
    """Shares of (query tile, KV tile) pairs the kernels skip (DEAD) and
    leave unmasked (FULL), by ``live_tiles``."""
    cls = fa.live_tiles(qpos.cpu(), kpos.cpu(), block_q, block_k, causal,
                        window)
    n = cls.numel()
    return {"pairs": n, "dead_share": int((cls == fa.DEAD).sum()) / n,
            "full_share": int((cls == fa.FULL).sum()) / n}


def phase_flash(torch, fa, hw) -> tuple[dict, list]:
    """Phase 11: the flash-attention kernels against their plain version on
    the card. At internlm2-1.8b's prefill (B = 4, H = 16, KV = 8, S = 2048,
    hd = 128, bf16, causal: the prefill kernel) and decode (one query
    against a 2080-slot cache whose last 31 slots are cold, NEG_POS; bf16
    and f32: the decode kernel) shapes: error against the plain version in
    f32 (the reference test's oracle) under the bars, a control per shape
    that must fail them, kernel, plain and SDPA times (decode: queued behind
    a sleep, so the host's enqueue does not pace them; the paced time
    beside), the bounds (the causal-useful work; the full tiles beside it),
    the tile skip and the decode split plan; the f32 kernel at the prefill
    shape beside f32 SDPA, with its bound; and the prefill kernel on a
    decode's K/V (Sq = 17). Then the decode kernel at GQA groups 1, 2, 4
    and 8 and Sq 2 to 16 under the decode bars; shuffled key positions,
    positions with NEG_POS holes and a window, non-monotone query positions,
    ragged Sq and Skv against the 128-row tiles, head dims 64, 128 and 256,
    the reference test's f32 shape, windows, head dim 16 (zero-padded); a
    fully masked row on the prefill, decode and f32 kernels (the mean of v,
    or zero with ``zero_empty_rows``); transposed (B, S, H, hd) views,
    which must give the contiguous result bit for bit at prefill and
    decode. Returns (record, the prefill and decode kernel rows without
    launches)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(b, h, kv, sq, skv, hd, dtype):
        def draw(*shape):
            return torch.randn(*shape, generator=gen, device=DEV)
        q = draw(b, h, sq, hd) * hd ** -0.5      # as attend scales q
        return (q.to(dtype), draw(b, kv, skv, hd).to(dtype),
                draw(b, kv, skv, hd).to(dtype))

    def oracle(q, k, v, qpos, kpos, causal=True, window=0):
        return fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        qpos, kpos, causal=causal,
                                        window=window)

    def ratio(got, want, bars):
        """max |err| / (atol + rtol |want|) over the elements and bars."""
        d, w = (got.double() - want.double()).abs(), want.double().abs()
        return max(float((d / (a + r * w)).max()) for a, r in bars)

    def bars_of(dtype):
        return FLASH_F32_BARS if dtype == f32 else FLASH_BF16_BARS

    def check(name, q, k, v, qpos, kpos, causal=True, window=0, bars=None):
        got = fa.flash_attention(q, k, v, qpos, kpos, causal=causal,
                                 window=window)
        r = ratio(got, oracle(q, k, v, qpos, kpos, causal, window),
                  bars or bars_of(q.dtype))
        expect(r <= 1.0 and got.dtype == q.dtype and got.shape == q.shape,
               f"flash_attention {name}: error {r} x its bar")
        return got, r

    def control(name, q, k, v, qpos, kpos, kpos_seen, bars):
        """The kernel given ``kpos_seen`` (what a faulty mask would let in)
        against the oracle on the true ``kpos``: it must break the bars."""
        r = ratio(fa.flash_attention(q, k, v, qpos, kpos_seen),
                  oracle(q, k, v, qpos, kpos), bars)
        expect(r > 1.0, f"control {name}: error {r} x the bar; the bar "
               f"would not catch the fault")
        return r

    def bound(flops, nbytes, peak):
        t_ops, t_bytes = flops / peak, nbytes / hw.HBM_BW
        return {"bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "ops_ms": 1e3 * t_ops, "bytes_ms": 1e3 * t_bytes}

    def transposed(*ts):
        """The same values as (B, S, H, hd) tensors' transposed views."""
        return (t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts)

    def masked_row(name, q, k, v, qp, kp, bars, empty):
        """Rows ``empty`` see no key: the mean of v (the reference kernel's
        result), zero with zero_empty_rows, every other row unchanged."""
        got, r = check(name, q, k, v, qp, kp, bars=bars)
        g = q.shape[1] // k.shape[1]
        mean_v = v.float().mean(dim=2).repeat_interleave(g, dim=1)
        expect(ratio(got[:, :, empty], mean_v[:, :, None].expand(
            -1, -1, len(empty), -1), bars) <= 1.0,
               f"{name}: not the mean of v")
        zero = fa.flash_attention(q, k, v, qp, kp, zero_empty_rows=True)
        keep = [i for i in range(q.shape[2]) if i not in empty]
        expect(bool((zero[:, :, empty] == 0).all())
               and bool(torch.equal(zero[:, :, keep], got[:, :, keep])),
               f"{name}: zero_empty_rows did not zero exactly those rows")
        return r

    rec = {"phase": 11, "bars": {"f32": FLASH_F32_BARS,
                                 "bf16": FLASH_BF16_BARS,
                                 "bf16_decode": FLASH_DECODE_BARS}}
    b, h, kvh, s, hd = LM_BATCH, LM_HEADS, LM_KV_HEADS, LM_PROMPT, LM_HD
    # --- prefill shape: the causal-useful work is key <= query, 4 * B * H *
    # hd * S (S + 1) / 2 FLOPs; the full tiles (4 B H S^2 hd) beside it
    q, k, v = qkv(b, h, kvh, s, s, hd, bf16)
    pos = torch.arange(s, dtype=torch.int32, device=DEV)
    _, r_p = check("prefill", q, k, v, pos, pos)
    flops = 4.0 * b * h * hd * s * (s + 1) / 2
    full_flops = 4.0 * b * h * s * s * hd
    bytes_p = 2.0 * (2 * b * h * s * hd + 2 * b * kvh * s * hd) + 8.0 * s
    prefill = {
        "shape": [b, h, kvh, s, s, hd], "dtype": "bfloat16", "causal": True,
        "err_over_bar": r_p,
        "control_past_causal_edge": control(
            "prefill, one key past the causal edge", q, k, v, pos, pos,
            (pos - 1).clamp(min=0), FLASH_BF16_BARS),
        "max_abs_err": max_err(fa.flash_attention(q, k, v, pos, pos),
                               oracle(q, k, v, pos, pos)),
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, pos, pos), reps=20),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, pos,
                                                             pos), reps=2),
        "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=1.0, enable_gqa=True), reps=20),
        "gflop": flops / 1e9, "gflop_full_tiles": full_flops / 1e9,
        "gbytes": bytes_p / 1e9,
        "tiles": tile_shares(fa, pos, pos, hw.FLASH_BLOCK_Q,
                             hw.FLASH_BLOCK_K),
        **bound(flops, bytes_p, hw.PEAK_FLOPS_BF16),
        "full_work_ms": 1e3 * full_flops / hw.PEAK_FLOPS_BF16}
    prefill["tflops_useful"] = flops / prefill["ms"] / 1e9
    rec["prefill"] = prefill
    # transposed views of (B, S, H, hd) tensors: the attend route's layout
    expect(bool(torch.equal(fa.flash_attention(*transposed(q, k, v), pos,
                                               pos),
                            fa.flash_attention(q, k, v, pos, pos))),
           "flash_attention on strided views differs from contiguous inputs")
    del q, k, v
    torch.cuda.empty_cache()
    # --- the f32 kernel (flash_f32_kernel, CUDA-core FMAs) at the prefill
    # shape beside f32 SDPA; its bound is the causal-useful work at the f32
    # CUDA-core peak (the kernel visits every tile: the full work beside)
    q, k, v = qkv(b, h, kvh, s, s, hd, f32)
    _, r_f = check("prefill f32", q, k, v, pos, pos)
    bytes_f = 4.0 * (2 * b * h * s * hd + 2 * b * kvh * s * hd) + 8.0 * s
    prefill_f32 = {
        "shape": [b, h, kvh, s, s, hd], "dtype": "float32", "causal": True,
        "err_over_bar": r_f,
        "max_abs_err": max_err(fa.flash_attention(q, k, v, pos, pos),
                               oracle(q, k, v, pos, pos)),
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, pos, pos), reps=3),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, pos,
                                                             pos), reps=1),
        "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=1.0, enable_gqa=True), reps=3),
        **bound(flops, bytes_f, hw.PEAK_FLOPS_F32),
        "full_work_ms": 1e3 * full_flops / hw.PEAK_FLOPS_F32}
    prefill_f32["tflops_useful"] = flops / prefill_f32["ms"] / 1e9
    # the kernel's own tiles: hb heads of a GQA group x pb positions a
    # block against KV tiles of bk keys; the skip share at this shape
    hb, pb, bk = fa.f32_tiles(hd, h // kvh)
    prefill_f32["tiles"] = dict(tile_shares(fa, pos, pos, pb, bk),
                                heads_a_block=hb, positions_a_block=pb,
                                keys_a_tile=bk)
    prefill_f32["full_tile_work_visited_ms"] = (
        1e3 * (1.0 - prefill_f32["tiles"]["dead_share"]) * full_flops
        / hw.PEAK_FLOPS_F32)
    expect(bool(torch.equal(fa.flash_attention(*transposed(q, k, v), pos,
                                               pos),
                            fa.flash_attention(q, k, v, pos, pos))),
           "flash_attention f32 on strided views differs from contiguous "
           "inputs")
    rec["prefill_f32"] = prefill_f32
    del q, k, v
    torch.cuda.empty_cache()
    # --- decode shape: one query at position 2048, slots 2049.. cold; a
    # kernel without the kpos >= 0 test would take the cold slots as keys
    # before the query (the control hands it kpos clamped at 0)
    skv = LM_PROMPT + LM_GEN
    kpos = torch.arange(skv, dtype=torch.int32, device=DEV)
    kpos[LM_PROMPT + 1:] = NEG_POS
    cold_in = kpos.clamp(min=0)
    qpos = torch.tensor([LM_PROMPT], dtype=torch.int32, device=DEV)
    valid = LM_PROMPT + 1
    decode = {}
    for dt, bars in ((f32, FLASH_F32_BARS), (bf16, FLASH_DECODE_BARS)):
        name = "decode_" + str(dt).split(".")[1]
        q, k, v = qkv(b, h, kvh, 1, skv, hd, dt)
        _, r_d = check(name, q, k, v, qpos, kpos, bars=bars)
        elem = q.element_size()
        flops_d = 4.0 * b * h * valid * hd
        bytes_d = elem * (2 * b * h * hd + 2 * b * kvh * valid * hd) \
            + 4.0 * (valid + 1)
        d = {"shape": [b, h, kvh, 1, skv, hd], "cold_slots": skv - valid,
             "err_over_bar": r_d,
             "control_cold_slots_in": control(
                 name + ", cold slots let in", q, k, v, qpos, kpos, cold_in,
                 bars),
             "max_abs_err": max_err(fa.flash_attention(q, k, v, qpos, kpos),
                                    oracle(q, k, v, qpos, kpos)),
             "ms": queued_ms(lambda: fa.flash_attention(q, k, v, qpos,
                                                        kpos)),
             "paced_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, qpos,
                                                            kpos), reps=20),
             "plan": decode_plan(fa, b, h, kvh, 1, skv, hd, dt),
             "tiles": tile_shares(fa, qpos, kpos, 1,
                                  hw.FLASH_DECODE_TILE_BYTES
                                  // (2 * hd * elem)),
             "mbytes": bytes_d / 1e6,
             **bound(flops_d, bytes_d, hw.PEAK_FLOPS_BF16 if dt == bf16
                     else hw.PEAK_FLOPS_F32)}
        d["gbytes_per_s"] = bytes_d / d["ms"] / 1e6
        expect(bool(torch.equal(
            fa.flash_attention(*transposed(q, k, v), qpos, kpos),
            fa.flash_attention(q, k, v, qpos, kpos))),
            f"{name} on strided views differs from contiguous inputs")
        if dt == bf16:
            mask = (kpos >= 0)[None, :] & (kpos[None, :] <= qpos[:, None])
            d["plain_ms"] = queued_ms(lambda: fa.flash_attention_plain(
                q, k, v, qpos, kpos), reps=20)
            d["sdpa_ms"] = queued_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0, enable_gqa=True))
            # the prefill kernel on the same K/V: Sq just past the decode
            # kernel's, so one 128-row tile per (batch, head)
            sq = hw.FLASH_DECODE_MAX_SQ + 1
            qm = qkv(b, h, kvh, sq, 1, hd, dt)[0]
            qmp = torch.arange(LM_PROMPT - sq + 1, LM_PROMPT + 1,
                               dtype=torch.int32, device=DEV)
            check("decode K/V on the prefill kernel", qm, k, v, qmp, kpos)
            d["prefill_kernel_sq17_ms"] = queued_ms(
                lambda: fa.flash_attention(qm, k, v, qmp, kpos), reps=20)
        decode[name] = d
        del q, k, v
    rec["decode"] = decode
    decode = decode["decode_bfloat16"]
    # --- the decode kernel's row packing: GQA groups and Sq (rows g * Sq +
    # i a block), bf16 at 2080 slots, the last queries at the cold edge
    errs = {}
    for g in (1, 2, 4, 8):
        for sq in (1, 2, 3, 5, 8, 13, 16):
            q, k, v = qkv(2, 4 * g, 4, sq, skv, hd, bf16)
            qp = torch.arange(valid - sq, valid, dtype=torch.int32,
                              device=DEV)
            errs[f"decode_g{g}_sq{sq}"] = check(
                f"decode, group {g}, Sq {sq}", q, k, v, qp, kpos,
                bars=FLASH_DECODE_BARS)[1]
    rec["decode_packing_err_over_bar"] = errs
    # --- positions that are not in order, and the edges
    errs = {}
    perm = torch.randperm(333, generator=gen, device=DEV).to(torch.int32)
    holes = perm.clone()
    holes[torch.rand(333, generator=gen, device=DEV) < 0.2] = NEG_POS
    ring = torch.randperm(skv, generator=gen, device=DEV).to(torch.int32)
    ring[torch.rand(skv, generator=gen, device=DEV) < 0.2] = NEG_POS
    shuffled_q = torch.randperm(200, generator=gen,
                                device=DEV).to(torch.int32)
    ar = torch.arange(4096, dtype=torch.int32, device=DEV)
    for name, (bb, hh, kk, sq, skv_, d), dt, qp, kp, causal, window in [
            ("prefill_shuffled_kpos", (2, 4, 2, 333, 333, 128), bf16,
             ar[:333], perm, True, 0),
            ("prefill_holes_window", (2, 4, 2, 333, 333, 128), bf16,
             ar[:333], holes, True, 100),
            ("prefill_non_monotone_qpos", (1, 4, 1, 200, 257, 64), bf16,
             shuffled_q, ar[:257], True, 0),
            ("decode_shuffled_ring_holes", (2, 8, 2, 4, skv, 128), bf16,
             ar[valid - 549:valid - 545], ring, True, 0),
            ("decode_ring_window", (2, 8, 2, 3, skv, 128), bf16,
             ar[valid - 149:valid - 146], ring, True, 512),
            ("ragged_129_70", (1, 4, 2, 129, 70, 128), bf16, ar[:129],
             ar[:70], False, 0),
            ("ragged_1000_1000", (1, 4, 2, 1000, 1000, 128), bf16, ar[:1000],
             ar[:1000], True, 0),
            ("ref_f32", (1, 4, 2, 512, 512, 64), f32, ar[:512], ar[:512],
             True, 0),
            ("ref_f32_window", (1, 4, 2, 512, 512, 64), f32, ar[:512],
             ar[:512], True, 128),
            ("ref_f32_full", (1, 4, 2, 512, 512, 64), f32, ar[:512],
             ar[:512], False, 0),
            ("ref_bf16_window", (1, 4, 2, 512, 512, 64), bf16, ar[:512],
             ar[:512], True, 128),
            ("ragged_window", (2, 4, 2, 333, 333, 128), f32, ar[:333],
             ar[:333], True, 100),
            ("ragged_window_bf16", (2, 4, 2, 333, 333, 128), bf16, ar[:333],
             ar[:333], True, 100),
            ("hd64", (1, 8, 4, 300, 300, 64), bf16, ar[:300], ar[:300], True,
             0),
            ("hd256", (1, 8, 4, 257, 257, 256), bf16, ar[:257], ar[:257],
             True, 0),
            ("decode_hd64", (2, 8, 2, 2, skv, 64), bf16, ar[valid - 2:valid],
             kpos, True, 0),
            ("decode_hd256", (2, 8, 2, 2, skv, 256), bf16, ar[valid - 2:valid],
             kpos, True, 0),
            ("hd16_padded", (1, 4, 2, 100, 100, 16), f32, ar[:100], ar[:100],
             True, 0),
            # the f32 kernel: positions out of order, head dims, GQA packing
            # (groups 1, 3, 4, 8, 16: 1, 1, 4, 8, 8 heads a block), Sq just
            # past the decode kernel's on a cold-slot cache
            ("f32_shuffled_kpos", (2, 4, 2, 333, 333, 128), f32, ar[:333],
             perm, True, 0),
            ("f32_holes_window", (2, 4, 2, 333, 333, 128), f32, ar[:333],
             holes, True, 100),
            ("f32_non_monotone_qpos", (1, 4, 1, 200, 257, 64), f32,
             shuffled_q, ar[:257], True, 0),
            ("f32_hd64", (1, 8, 4, 300, 300, 64), f32, ar[:300], ar[:300],
             True, 0),
            ("f32_hd256", (1, 8, 4, 257, 257, 256), f32, ar[:257], ar[:257],
             True, 0),
            ("f32_hd256_window", (2, 4, 2, 300, 300, 256), f32, ar[:300],
             ar[:300], True, 77),
            ("f32_g1", (1, 4, 4, 200, 200, 128), f32, ar[:200], ar[:200],
             True, 0),
            ("f32_g3", (1, 6, 2, 150, 190, 64), f32, ar[40:190], ar[:190],
             True, 0),
            ("f32_g4_window", (1, 8, 2, 200, 200, 128), f32, ar[:200],
             ar[:200], True, 33),
            ("f32_g8", (1, 16, 2, 130, 130, 64), f32, ar[:130], ar[:130],
             True, 0),
            ("f32_g16_full", (1, 16, 1, 100, 120, 128), f32, ar[:100],
             ar[:120], False, 0),
            ("f32_sq17_cold_slots", (2, 8, 2, 17, skv, 128), f32,
             ar[valid - 17:valid], kpos, True, 0)]:
        q, k, v = qkv(bb, hh, kk, sq, skv_, d, dt)
        errs[name] = check(name, q, k, v, qp, kp, causal, window)[1]
    # a fully masked row: the mean of v, as the reference kernel gives;
    # zero with zero_empty_rows (attend's contract), every other row
    # unchanged; on the f32, prefill and decode kernels
    for dt in (f32, bf16):
        name = "fully_masked_row_" + str(dt).split(".")[1]
        q, k, v = qkv(1, 4, 2, 512, 512, 64, dt)
        qp = ar[:512]
        errs[name] = masked_row(name, q, k, v, qp, qp + 1, bars_of(dt), [0])
    # the f32 kernel's empty rows: at the start, inside and at the end of a
    # block's tile, GQA groups 4 (packed) and 1, head dims 128 and 256
    for name, (hh, kk, d, empty) in (
            ("f32_masked_rows_g4", (8, 2, 128, [0, 37, 130, 299])),
            ("f32_masked_rows_hd256", (4, 4, 256, [5, 64, 200]))):
        q, k, v = qkv(1, hh, kk, 300, 300, d, f32)
        qp = ar[:300].clone()
        qp[empty] = -5
        errs[name] = masked_row(name, q, k, v, qp, ar[:300], FLASH_F32_BARS,
                                empty)
    for dt, bars in ((f32, FLASH_F32_BARS), (bf16, FLASH_DECODE_BARS)):
        name = "decode_masked_rows_" + str(dt).split(".")[1]
        q, k, v = qkv(2, 8, 2, 4, skv, hd, dt)
        qp = torch.tensor([-7, 100, 2048, -1], dtype=torch.int32,
                          device=DEV)
        errs[name] = masked_row(name, q, k, v, qp, kpos, bars, [0, 3])
    rec["edges_err_over_bar"] = errs
    rec["library_call"] = ("F.scaled_dot_product_attention(enable_gqa=True, "
                           "scale=1.0): is_causal at prefill, the boolean "
                           "mask at decode")
    common = {"route": "cuda",
              "source": "src/repro_torch/csrc/fk_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:76"}
    rows = [dict(common, name="flash_attention",
                 max_abs_err=prefill["max_abs_err"], ms=prefill["ms"],
                 plain_ms=prefill["plain_ms"], bound_ms=prefill["bound_ms"],
                 bound_by=prefill["bound_by"],
                 library_ms=prefill["sdpa_ms"]),
            dict(common, name="flash_attention_decode",
                 max_abs_err=decode["max_abs_err"], ms=decode["ms"],
                 plain_ms=decode["plain_ms"], bound_ms=decode["bound_ms"],
                 bound_by=decode["bound_by"], library_ms=decode["sdpa_ms"])]
    torch.cuda.empty_cache()
    return rec, rows


@contextlib.contextmanager
def plain_attention(attn):
    """``attend`` on the card through the chunked plain math instead of the
    flash kernel (the CPU route), for the teacher-forced comparison."""
    kernel = attn._attend_kernel
    attn._attend_kernel = attn._attend_local
    try:
        yield
    finally:
        attn._attend_kernel = kernel


def phase_lm_serve(torch, fa, KMeans, FaultPolicy,
                   InjectionCampaign) -> dict:
    """Phase 12: ``repro_torch.launch.serve.main`` serves 8 requests of
    internlm2-1.8b at full width (2 waves of 4, prompt 2048, 32 generated
    tokens) with seeded weights; every attention of prefill and decode
    runs the flash kernel (24 layers x 2 waves x (1 prefill + 31 decode
    steps) launches). Then the first wave again, teacher-forced, through
    the kernel route and the plain ``attend`` route: logits within
    LM_LOGIT_RTOL x max|logit| at the prefill and every decode step (greedy
    agreement printed, not gated); ``torch.profiler`` traces of one prefill
    and one decode step; and ``examples/kv_quantize.py``'s flow at full
    width: an FT K-means codebook over the wave's prefill key cache."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models import attention as attn
    from repro_torch.models.model import greedy
    cfg = get_config(LM_ARCH, smoke=LM_SMOKE)
    argv = ["--arch", LM_ARCH, "--smoke" if LM_SMOKE else "--no-smoke",
            "--requests", str(LM_REQUESTS), "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN),
            "--device", DEV]
    fa.flash_attention.launches = 0
    for key in fa.flash_attention.kernel_launches:
        fa.flash_attention.kernel_launches[key] = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = serve.main(argv)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    by_kernel = dict(fa.flash_attention.kernel_launches)
    waves = -(-LM_REQUESTS // LM_BATCH)
    want = cfg.num_layers * waves * LM_GEN
    lines = text.getvalue().strip().splitlines()
    expect(f"served {LM_REQUESTS}/{LM_REQUESTS}" in text.getvalue(),
           f"the launcher did not serve every request: {lines}")
    expect(out["finite"], "non-finite logits while serving")
    expect(launches == want, f"flash_attention launched {launches} times "
           f"while serving, want {want}")
    # one prefill launch a layer and wave, one decode launch a layer and
    # step after the first token
    dtype = getattr(torch, cfg.dtype)
    want_by = dict.fromkeys(by_kernel, 0)
    want_by[fa.kernel_for(LM_PROMPT, dtype)] += cfg.num_layers * waves
    want_by[fa.kernel_for(1, dtype)] += cfg.num_layers * waves * (LM_GEN - 1)
    expect(by_kernel == want_by, f"flash kernels launched {by_kernel} "
           f"while serving, want {want_by}")
    decode_ms = 1e3 * sum(out["decode_s"]) / out["decode_steps"]
    rec = {"phase": 12, "arch": LM_ARCH, "argv": argv, "launcher": lines,
           "params_b": cfg.param_count() / 1e9,
           "flash_launches": launches,
           "flash_launches_by_kernel": by_kernel,
           "prefill_ms": [1e3 * t for t in out["prefill_s"]],
           "decode_ms_per_step": decode_ms,
           "decode_ms_per_wave": [1e3 * t for t in out["decode_s"]],
           "tokens": out["tokens"], "serve_s": out["seconds"],
           "tokens_per_s": out["tokens"] / out["seconds"]}
    # --- teacher-forced: kernel route against the plain attend route
    lm = LM(cfg, device=DEV, seed=0)
    prompts = torch.as_tensor(out["prompts"][:LM_BATCH], dtype=torch.int32,
                              device=DEV)
    forced = torch.as_tensor(out["generated"][:LM_BATCH], dtype=torch.int32,
                             device=DEV)
    max_len = LM_PROMPT + LM_GEN
    errs, agree = [], []

    def compare(kern, plain, what):
        err = max_err(kern, plain) / float(plain.abs().max())
        expect(err <= LM_LOGIT_RTOL, f"{what}: kernel-route logits "
               f"{err} x max|logit| from the plain route")
        errs.append(err)
        agree.append(float((greedy(kern) == greedy(plain)).float().mean()))

    with torch.no_grad():
        logits_k, caches_k = lm.prefill({"tokens": prompts}, max_len)
        expect(bool(torch.isfinite(logits_k).all()), "non-finite logits")
        greedy_k = [greedy(logits_k)]
        with plain_attention(attn):
            logits_p, caches_p = lm.prefill({"tokens": prompts}, max_len)
        compare(logits_k, logits_p, "prefill")
        del logits_k, logits_p
        torch.cuda.empty_cache()
        for t in range(LM_GEN - 1):
            tok, pos = forced[:, t:t + 1], LM_PROMPT + t
            lk, caches_k = lm.decode_step(caches_k, tok, pos)
            with plain_attention(attn):
                lp, caches_p = lm.decode_step(caches_p, tok, pos)
            compare(lk, lp, f"decode step {t}")
            greedy_k.append(greedy(lk))
        launcher_match = float((torch.cat(greedy_k, 1) == forced)
                               .float().mean())
        del caches_p
        torch.cuda.empty_cache()
        rec["teacher_forced"] = {
            "max_err_over_max_logit": max(errs), "prefill_err": errs[0],
            "decode_errs": errs[1:], "tolerance": LM_LOGIT_RTOL,
            "greedy_agreement_kernel_vs_plain": agree,
            "kernel_route_greedy_equals_launcher": launcher_match}
        # --- traces: one decode step (the last cache slot) and one prefill
        last = LM_PROMPT + LM_GEN - 1
        rec["decode_trace"] = device_trace(
            torch, lambda: lm.decode_step(caches_k, forced[:, -1:], last))
        rec["prefill_trace"] = device_trace(
            torch, lambda: lm.prefill({"tokens": prompts}, max_len))
        # --- the KV cache codebook (examples/kv_quantize.py at full width)
        keys = torch.stack([c["kv"].k[:, :LM_PROMPT] for c in caches_k])
        del caches_k, lm
        torch.cuda.empty_cache()
        vecs = keys.reshape(-1, keys.shape[-1]).float()
        del keys
    km, fit_s = wall(lambda: KMeans(
        n_clusters=KV_CODEBOOK, max_iter=25, random_state=0, device=DEV,
        fault=FaultPolicy.correct(injection=InjectionCampaign(rate=0.5)))
        .fit(vecs))
    recon = km.cluster_centers_[km.labels_.long()]
    rel = float(torch.linalg.norm(vecs - recon) / torch.linalg.norm(vecs))
    expect(math.isfinite(rel) and bool(torch.isfinite(
        km.cluster_centers_).all()), "KV codebook not finite")
    expect(km.detected_errors_ > 0, "KV codebook campaign detected nothing")
    rec["kv_codebook"] = {
        "rows": vecs.shape[0], "dim": vecs.shape[1], "k": KV_CODEBOOK,
        "gbytes_f32": 4.0 * vecs.numel() / 1e9, "fit_s": fit_s,
        "n_iter": km.n_iter_, "rel_recon_err": rel,
        "detected_errors": km.detected_errors_,
        "compression": vecs.shape[1] * 2 / (
            2 + km.cluster_centers_.numel() * 2 / vecs.shape[0])}
    del vecs, recon, km
    torch.cuda.empty_cache()
    return rec


def near_tie_rows(torch, xp, cp, cn, am, am_p, what: str) -> int:
    """Rows whose kernel label differs from the plain version's. Each must be
    a near tie of the plain distances (the two best within LOWP_TIE_RTOL of
    the larger's magnitude) and they may be at most LOWP_TIE_SHARE of the
    rows: the tensor cores sum a k-step in their own order, so a label may
    move only where f32 rounding can decide. Returns their count."""
    rows = (am != am_p).nonzero()[:, 0]
    n = int(rows.numel())
    if n:
        d = cn[None, :] - 2.0 * (xp[rows].float() @ cp.float().T)
        two = d.topk(2, dim=1, largest=False).values
        gap = two[:, 1] - two[:, 0]
        scale = torch.maximum(two[:, 0].abs(), two[:, 1].abs())
        expect(bool((gap <= LOWP_TIE_RTOL * scale).all()),
               f"{what}: {n} labels differ from the plain version's, not "
               f"all on near ties")
    expect(n <= LOWP_TIE_SHARE * am.numel(),
           f"{what}: {n} of {am.numel()} labels differ from the plain "
           f"version's")
    return n


def phase_lowp_kernels(torch, ops, kern, dtype) -> dict:
    """Phase 13 (a): the 2-byte variants of the four kernels and
    ``tile_update`` against their plain versions at phase 2's shapes, with
    phase 2's planted FT faults."""
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import update as up
    da, ll, daft, llft = kern
    dt = getattr(torch, dtype)
    out = []
    for k in (1000, 100):
        x_np, _ = make_blobs(M_SMALL, F_SMALL, k, seed=SEED + k)
        x = torch.from_numpy(x_np).cuda().to(dt)
        c = torch.from_numpy(blob_centers(k, F_SMALL, SEED + k)).cuda()
        params = ops.clamp_params(M_SMALL, k, F_SMALL, ops.DEFAULT_PARAMS)
        plan, cp, cn, _ = ops._resolve_padded(ops.plan_data(x, params), c,
                                              None)
        mp, fp = plan.xp.shape
        kp, bm = cp.shape[0], params.block_m
        nt = mp // bm
        tiles = dict(block_m=bm, block_k=params.block_k,
                     block_f=params.block_f)
        factor = ops.threshold_factor(fp, dt)
        rec = {"k": k, "tol_rel": 1e-5}
        md, am = da.distance_argmin(plan.xp, cp, cn, **tiles)
        md_p, am_p = da.distance_argmin_plain(plan.xp, cp, cn)
        ok, rec["distance_argmin_err"] = rel_ok(md, md_p, 1e-5)
        expect(ok, f"{dtype} distance_argmin min distances K={k}")
        rec["near_tie_labels"] = near_tie_rows(
            torch, plan.xp, cp, cn, am, am_p, f"{dtype} distance_argmin K={k}")

        r = ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)
        expect(bool(torch.equal(r[1], am)) and bool(torch.equal(r[0], md)),
               f"{dtype} lloyd_step assignment differs from distance_argmin "
               f"K={k}")
        valid = (torch.arange(mp, device=x.device) < plan.m).view(nt, bm)
        s_p, c_p = ll.tile_update_plain(plan.xp.view(nt, bm, fp),
                                        am.view(nt, bm), valid, kp)
        r_sums = entry_sums(up, r, bm)
        ok, rec["lloyd_step_sums_err"] = rel_ok(
            r_sums[0], up.tree_sum_plain(s_p), 1e-5)
        expect(ok and bool(torch.equal(r_sums[1], up.tree_sum_plain(c_p))),
               f"{dtype} lloyd_step sums/counts vs the plain update K={k}")
        del s_p, c_p
        rec["onepass_entries"] = check_onepass(
            torch, up, ll, r, plan.xp, kp, plan.m, bm,
            f"{dtype} lloyd_step K={k}", order_matters=False)
        fl = ops.fused_lloyd(plan, c)
        fused = ops.tiled_update(plan, fl[0], k)
        expect(all(bool(torch.equal(a, b)) for a, b in zip(fl[2:], fused)),
               f"{dtype} fused_lloyd sums are not the two-pass update's "
               f"K={k}")
        rec["update_routes"] = {"kernel_labels": check_update_route(
            torch, up, ll, plan.xp, am, kp, plan.m, bm,
            f"{dtype} labels of distance_argmin K={k}",
            order_matters=False)}
        for i, kind in enumerate(UPDATE_LABELS):
            rec["update_routes"][kind] = check_update_route(
                torch, up, ll, plan.xp,
                update_labels(torch, kind, plan.m, mp, k, SEED + i), kp,
                plan.m, bm, f"{dtype} {kind} labels K={k}",
                order_matters=False)
        # rows scaled by 2^-14 .. 2^8 (finite in fp16): 2-byte sums whose
        # bits hang on the order, so the control must break them
        gen = torch.Generator(device=x.device).manual_seed(SEED + k)
        scale = torch.exp2(torch.randint(-14, 9, (mp, 1), generator=gen,
                                         device=x.device).float())
        xw = (plan.xp.float() * scale).to(dt)
        expect(bool(torch.isfinite(xw).all()), f"{dtype} scaled rows")
        rec["update_routes"]["wide_rows"] = check_update_route(
            torch, up, ll, xw,
            update_labels(torch, "random", plan.m, mp, k, SEED), kp,
            plan.m, bm, f"{dtype} rows scaled over 23 binades K={k}")
        # the one-pass step's entries on those rows: the control must break
        # the bits there
        rec["onepass_entries"]["wide_rows"] = check_onepass(
            torch, up, ll, ll.lloyd_step(xw, cp, cn, plan.m, **tiles), xw,
            kp, plan.m, bm, f"{dtype} lloyd_step, rows scaled over 23 "
            f"binades K={k}")
        del xw, scale

        no_d = daft.no_injection().cuda()
        f_md, f_am, f_det = daft.distance_argmin_ft(
            plan.xp, cp, cn, no_d, factor=factor, **tiles)
        p_md, _, p_det = daft.distance_argmin_ft_plain(
            plan.xp, cp, cn, no_d, bm, params.block_k, params.block_f,
            factor)
        rec["clean_det"] = int(f_det.sum())
        expect(rec["clean_det"] == 0 and int(p_det.sum()) == 0,
               f"clean {dtype} distance_argmin_ft detected "
               f"{rec['clean_det']} K={k}")
        expect(bool(torch.equal(f_md, md)) and bool(torch.equal(f_am, am)),
               f"clean {dtype} distance_argmin_ft differs from "
               f"distance_argmin K={k}")
        ok, rec["distance_argmin_ft_err"] = rel_ok(f_md, p_md, 1e-5)
        expect(ok, f"{dtype} distance_argmin_ft vs plain K={k}")
        inj = ops.plan_injection_tile(M_SMALL, k, F_SMALL, params,
                                      row=M_SMALL // 3, col=k - 3, f_step=1,
                                      delta=2.0 ** 20).cuda()
        _, i_am, i_det = daft.distance_argmin_ft(plan.xp, cp, cn, inj,
                                                 factor=factor, **tiles)
        rec["fault_det"] = int(i_det.sum())
        expect(rec["fault_det"] == 1 and bool(torch.equal(i_am, am)),
               f"{dtype} distance fault not corrected once K={k}")

        no_l = llft.no_injection().cuda()
        q = llft.lloyd_step_ft(plan.xp, cp, cn, no_l, plan.m, factor=factor,
                               **tiles)
        expect(int(q[2].sum()) == 0, f"clean {dtype} lloyd_step_ft detected "
               f"K={k}")
        expect(bool(torch.equal(q[1], am)) and bool(torch.equal(q[5], r[4]))
               and all(bool(torch.equal(a, b)) for a, b in zip(
                   entry_sums(up, q, bm), r_sums)),
               f"{dtype} lloyd_step_ft labels/entries/sums differ from "
               f"lloyd_step K={k}")
        # the expected update checksums against their definition on the
        # kernel's own labels (the plain version's may move on near ties)
        vf = valid.float()
        enc = torch.stack([vf, vf * (am.view(nt, bm) + 1).float()], -1)
        ok, rec["lloyd_step_ft_ucheck_err"] = rel_ok(
            q[8], torch.bmm(enc.transpose(1, 2),
                            plan.xp.float().view(nt, bm, fp)), 1e-5)
        expect(ok and bool(torch.equal(q[9], enc.sum(1))),
               f"{dtype} lloyd_step_ft update checksums vs their definition "
               f"K={k}")
        del vf, enc
        clean = ops.fused_lloyd_ft(plan, c, inj=no_l)
        expect(int(clean[4]) == 0 and all(
            bool(torch.equal(a, b)) for a, b in zip(clean[:4], fl)),
               f"clean {dtype} fused_lloyd_ft detected {int(clean[4])} or "
               f"is not fused_lloyd K={k}")
        rec["ft_cases"] = check_ft_cases(torch, ops, llft, plan, c, cp, cn,
                                         params, am, k, f"{dtype} K={k}")
        out.append(rec)
        del plan, r, q, clean, fl, fused
        torch.cuda.empty_cache()
    return out


def clean_margin_log2(run, factor: float, steps: int = 14) -> list:
    """[lo, hi]: log2 of the threshold over the largest clean residual of
    any tile lies in [lo, hi). ``run(f)`` launches the FT kernel clean with
    threshold factor ``f`` and returns its detections; the factor is lowered
    by 2**-e, e bisected in [0, 64], until a launch flags."""
    if run(factor) > 0:
        return [float("-inf"), 0.0]
    lo, hi = 0.0, 64.0
    if run(factor * 2.0 ** -hi) == 0:
        return [hi, float("inf")]
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if run(factor * 2.0 ** -mid) > 0:
            hi = mid
        else:
            lo = mid
    return [lo, hi]


def phase_lowp(torch, ops, hw, kern, KMeans, FaultPolicy, InjectionCampaign,
               x, c_init, km_off, f32_ms, bound) -> tuple[dict, list]:
    """Phase 13: ``KMeans(compute_dtype="bfloat16"/"float16")`` on the
    tensor-core variants of the four kernels and ``tile_update``: (a) each
    against its plain version at phase 2's shapes, (b) full-size fits from
    phase 3's seeds (bitwise contracts, detections, exact inertia and
    labels against the f32 ``fused`` fit), (c) each variant's row at the
    phase-3 shape, (e) the clean residual margins of the FT kernels at f32,
    bf16 and fp16 and how far the campaign's smallest delta clears the
    thresholds."""
    from repro_torch.kernels import update as up
    da, ll, daft, llft = kern
    wrappers = {"distance_argmin": da.distance_argmin,
                "lloyd_step": ll.lloyd_step,
                "distance_argmin_ft": daft.distance_argmin_ft,
                "lloyd_step_ft": llft.lloyd_step_ft,
                "encode_centroids": daft.encode_centroids,
                "verify_entries": llft.verify_entries,
                "update_entries": up.update_entries,
                "tree_reduce": up.tree_reduce}
    replaces = {"distance_argmin": "src/repro/kernels/distance_argmin.py:140",
                "lloyd_step": "src/repro/kernels/lloyd_step.py:345",
                "distance_argmin_ft":
                    "src/repro/kernels/distance_argmin_ft.py:207",
                "lloyd_step_ft": "src/repro/kernels/lloyd_step_ft.py:292",
                "encode_centroids":
                    "src/repro/kernels/distance_argmin_ft.py:207 (the C "
                    "encodings of its checksums; the port's own pre-pass)"}
    base = dict(n_clusters=K_FULL, max_iter=ITERS, tol=0.0, random_state=SEED)
    xn = (x * x).sum(1)

    def exact_inertia(c):
        return float((ops.fused_assign(x, c)[1] + xn).sum())
    exact_f32 = exact_inertia(km_off.cluster_centers_)
    params = ops.clamp_params(M_FULL, K_FULL, F_FULL, ops.DEFAULT_PARAMS)
    bm, bk = params.block_m, params.block_k
    tiles = dict(block_m=bm, block_k=bk, block_f=params.block_f)
    centres = torch.from_numpy(blob_centers(K_FULL, F_FULL, SEED)).cuda()
    rec = {"phase": 13, "dtype": "float32 beside them", "m": M_FULL,
           "f": F_FULL, "k": K_FULL, "f32_ms_per_iter": f32_ms,
           "f32_fused_exact_inertia": exact_f32}
    rows, margins = [], {}
    for dtype, tag in (("bfloat16", "bf16"), ("float16", "fp16")):
        dt = getattr(torch, dtype)
        r = {"kernels": phase_lowp_kernels(torch, ops, kern, dtype)}
        # (b) the full-size fits, counting the launches of this dtype's path
        for w in wrappers.values():
            w.launches = 0
        kw = dict(base, compute_dtype=dtype)
        camp = FaultPolicy.correct(injection=InjectionCampaign(
            rate=1.0, targets="both"))
        km_f, f_s = wall(lambda: KMeans(**kw).fit(x, centroids=c_init))
        km_l, l_s = wall(lambda: KMeans(backend="lloyd", **kw)
                         .fit(x, centroids=c_init))
        km_ft, ft_s = wall(lambda: KMeans(fault=FaultPolicy.correct(), **kw)
                           .fit(x, centroids=c_init))
        km_c, c_s = wall(lambda: KMeans(fault=camp, **kw)
                         .fit(x, centroids=c_init))
        labels_f, labels_ft = km_f.predict(x), km_ft.predict(x)
        score = km_f.score(x)
        # labels_ of a fit at tol 0 are against the centroids before its
        # last update, so predict (the final centroids) is held to one more
        # step of each fit from its own centroids: the predict kernels
        # (distance_argmin / distance_argmin_ft) agree with the fit's
        one = dict(kw, max_iter=1)
        step_f = KMeans(**one).fit(x, centroids=km_f.cluster_centers_)
        step_ft = KMeans(fault=FaultPolicy.correct(), **one).fit(
            x, centroids=km_ft.cluster_centers_)
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in wrappers.items()}
        for n, v in launches.items():
            expect(v > 0, f"{dtype} {n} was not launched on the main path")
        expect(km_f._backend.name == "fused"
               and km_ft._backend.name == "lloyd_ft",
               f"{dtype} fits resolved to other backends")
        for a, b, what in ((km_l, km_f, "lloyd fit vs fused fit"),
                           (km_ft, km_l, "clean lloyd_ft fit vs lloyd fit"),
                           (km_c, km_ft, "campaign fit vs clean fit")):
            expect(bool(torch.equal(a.cluster_centers_, b.cluster_centers_))
                   and bool(torch.equal(a.labels_, b.labels_)),
                   f"{dtype} {what}: not bit for bit")
        expect(km_ft.detected_errors_ == 0 and km_c.detected_errors_ > 0,
               f"{dtype} detections: clean {km_ft.detected_errors_}, "
               f"campaign {km_c.detected_errors_}")
        expect(bool(torch.equal(labels_f, step_f.labels_))
               and bool(torch.equal(labels_ft, step_ft.labels_)),
               f"{dtype} predict differs from one more fit step's labels "
               f"(fused / fused_ft)")
        expect(km_f.cluster_centers_.dtype == torch.float32
               and bool(torch.isfinite(km_f.cluster_centers_).all())
               and math.isfinite(score) and score < 0,
               f"{dtype} centroids not finite f32, or score {score}")
        exact = exact_inertia(km_f.cluster_centers_)
        agree = float((km_f.labels_ == km_off.labels_).float().mean())
        r["fits"] = {
            "fused_ms_per_iter": 1e3 * f_s / km_f.n_iter_,
            "lloyd_ms_per_iter": 1e3 * l_s / km_l.n_iter_,
            "lloyd_ft_ms_per_iter": 1e3 * ft_s / km_ft.n_iter_,
            "campaign_ms_per_iter": 1e3 * c_s / km_c.n_iter_,
            "campaign_detected": km_c.detected_errors_,
            "inertia": km_f.inertia_, "exact_inertia": exact,
            "exact_inertia_rel_to_f32": exact / exact_f32 - 1.0,
            "label_agreement_with_f32": agree, "score": score,
            "predict_rows_moved_from_labels": int(
                (labels_f != km_f.labels_).sum()),
            "n_host_syncs": km_f._n_host_syncs, "launches": launches}
        expect(abs(exact / exact_f32 - 1.0) <= LOWP_INERTIA_RTOL
               and agree >= LOWP_LABEL_AGREEMENT,
               f"{dtype} fit: exact inertia {exact} vs f32 {exact_f32}, "
               f"labels agree {agree}")
        del km_f, km_l, km_ft, km_c, labels_f, labels_ft, step_f, step_ft
        torch.cuda.empty_cache()

        # (c) each variant at the phase-3 shape, blob centres as centroids
        plan, cp, cn, _ = ops._resolve_padded(
            ops.plan_data(x.to(dt), params), centres, None)
        mp, fp = plan.xp.shape
        kp, nt = cp.shape[0], mp // bm
        factor = ops.threshold_factor(fp, dt)
        no_d, no_l = daft.no_injection().cuda(), llft.no_injection().cuda()
        gemm = 2.0 * M_FULL * K_FULL * F_FULL
        x_bytes, c_bytes = 2.0 * M_FULL * F_FULL, 2.0 * K_FULL * F_FULL
        assign_out = 8.0 * M_FULL
        cn_lo = cn.to(dt)
        n_present = int((ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)[4]
                         >= 0).sum())
        ent_bytes = entry_bytes(n_present, F_FULL, K_FULL, nt)

        def library_call():
            d = torch.addmm(cn_lo[None, :], plan.xp, cp.T, beta=1.0,
                            alpha=-2.0)
            return d.min(dim=1)
        lib_ms = cuda_ms(library_call)
        specs = [
            ("distance_argmin",
             lambda: da.distance_argmin(plan.xp, cp, cn, **tiles),
             lambda: da.distance_argmin_plain(plan.xp, cp, cn),
             gemm, x_bytes + c_bytes + assign_out),
            ("lloyd_step",
             lambda: ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles),
             lambda: ll.lloyd_step_plain(plan.xp, cp, cn, plan.m, bm),
             gemm + M_FULL * F_FULL,
             x_bytes + c_bytes + assign_out + ent_bytes),
            ("distance_argmin_ft",
             lambda: daft.distance_argmin_ft(plan.xp, cp, cn, no_d,
                                             factor=factor, **tiles),
             lambda: daft.distance_argmin_ft_plain(
                 plan.xp, cp, cn, no_d, bm, bk, params.block_f, factor),
             gemm, x_bytes + c_bytes + assign_out + 4.0 * nt),
            ("lloyd_step_ft",
             lambda: llft.lloyd_step_ft(plan.xp, cp, cn, no_l, plan.m,
                                        factor=factor, **tiles),
             lambda: llft.lloyd_step_ft_plain(plan.xp, cp, cn, no_l, plan.m,
                                              bm, bk, params.block_f,
                                              factor),
             gemm + 3.0 * M_FULL * F_FULL, x_bytes + c_bytes + assign_out
             + ent_bytes + 4.0 * M_FULL + 4.0 * nt * (2 * F_FULL + 3)),
            # the FT kernels' pre-pass: C read once, its split encodings
            # written once
            ("encode_centroids",
             lambda: daft.encode_centroids(cp),
             lambda: daft.encode_centroids_plain(cp),
             2.0 * K_FULL * F_FULL, c_bytes + 16.0 * (kp // bk) * F_FULL),
        ]
        for name, kfn, pfn, ops_n, bytes_n in specs:
            if name == "encode_centroids":
                got, want = kfn(), pfn()
                expect(bool(torch.equal(got, want)),
                       f"{dtype} encode_centroids is not bit for bit its "
                       f"plain version")
                b_ms, b_by = bound(ops_n, bytes_n)
                rows.append({"name": f"{name}_{tag}", "route": "cuda",
                             "source": "src/repro_torch/csrc/fk_kernels.cu",
                             "replaces": replaces[name],
                             "launches": launches[name], "max_abs_err": 0.0,
                             "ms": cuda_ms(kfn, reps=20),
                             "plain_ms": cuda_ms(pfn, reps=2),
                             "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": None})
                continue
            k_out = canon(up, name, kfn(), bm)
            p_out = canon(up, name, pfn(), bm)
            near = near_tie_rows(torch, plan.xp, cp, cn, k_out[1], p_out[1],
                                 f"{dtype} {name} at the phase-3 shape")
            # distances against the plain version; an update's sums against
            # the plain update of the kernel's own labels
            err = max_err(k_out[0], p_out[0])
            expect(rel_ok(k_out[0], p_out[0], 1e-5)[0],
                   f"{dtype} {name} distances vs plain beyond rtol 1e-5")
            if name in ("lloyd_step", "lloyd_step_ft"):
                s_i = 2 if name == "lloyd_step" else 3
                valid = (torch.arange(mp, device=x.device)
                         < plan.m).view(nt, bm)
                s_p, c_p = ll.tile_update_plain(
                    plan.xp.view(nt, bm, fp), k_out[1].view(nt, bm), valid, kp)
                ok, s_err = rel_ok(k_out[s_i], up.tree_sum_plain(s_p), 1e-5)
                expect(ok and bool(torch.equal(k_out[s_i + 1],
                                               up.tree_sum_plain(c_p))),
                       f"{dtype} {name} sums/counts vs the plain update")
                err = max(err, s_err)
                del s_p, c_p
            del k_out, p_out
            torch.cuda.empty_cache()
            b_ms, b_by = bound(ops_n, bytes_n, peak=hw.PEAK_FLOPS_BF16)
            rows.append({"name": f"{name}_{tag}", "route": "cuda",
                         "source": "src/repro_torch/csrc/fk_kernels.cu",
                         "replaces": replaces[name],
                         "launches": launches[name], "max_abs_err": err,
                         "ms": cuda_ms(kfn), "plain_ms": cuda_ms(pfn, reps=2),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": lib_ms})
            r.setdefault("near_tie_labels_phase3", {})[name] = near
            torch.cuda.empty_cache()
        am = da.distance_argmin(plan.xp, cp, cn, **tiles)[1]
        sums_p = torch.empty((nt, kp, fp), device=x.device)
        counts_p = torch.empty((nt, kp), device=x.device)
        valid = (torch.arange(mp, device=x.device) < plan.m).view(nt, bm)

        def update():
            ll.tile_update(plan.xp, am, sums_p, counts_p, true_m=plan.m,
                           block_m=bm)

        def update_plain():
            return ll.tile_update_plain(plan.xp.view(nt, bm, fp),
                                        am.view(nt, bm), valid, kp)
        update()
        p_s, p_c = update_plain()
        ok, _ = rel_ok(sums_p, p_s, 1e-5)
        expect(ok and bool(torch.equal(counts_p, p_c)),
               f"{dtype} tile_update disagrees with its plain version")
        del p_s, p_c
        torch.cuda.empty_cache()
        r["dense_tile_update_ms"] = cuda_ms(update)
        r["compact_update"], rows_c = compact_update_rows(
            torch, up, plan, am, kp, bm, sums_p, counts_p, x_bytes, bound,
            launches, tag)
        rows.extend(rows_c)
        del sums_p, counts_p, am, valid
        torch.cuda.empty_cache()
        r.update(onepass_rows(torch, ops, up, llft, plan, centres, params,
                              bound, f"_{tag}")[0])
        margins[dtype] = lowp_margins(torch, ops, daft, llft, plan, cp, cn,
                                      params, tiles, dt)
        r["queue3_margins"] = margins[dtype]
        emit(dict(phase=13, dtype=dtype, **r))
        del plan, cp, cn, cn_lo
        torch.cuda.empty_cache()
    plan, cp, cn, _ = ops._resolve_padded(ops.plan_data(x, params), centres,
                                          None)
    margins["float32"] = lowp_margins(torch, ops, daft, llft, plan, cp, cn,
                                      params, tiles, torch.float32)
    rec["queue3_margins"] = {"float32": margins["float32"]}
    rec["library_calls"] = {
        "kernels": "addmm(cn, X, C^T, alpha=-2) + min(dim=1) in the 2-byte "
                   "dtype (tensor cores, 2-byte output)",
        "update_entries": "index_add_ into a (Kp, Fp) 2-byte accumulator"}
    del plan, cp, cn, xn
    torch.cuda.empty_cache()
    return rec, rows


def lowp_margins(torch, ops, daft, llft, plan, cp, cn, params, tiles,
                 dt) -> dict:
    """Phase 13 (e): the clean residual margin of each FT kernel at the
    phase-3 shape (log2 of threshold / largest residual, bracketed), and
    how far the campaign's smallest delta clears each slot's thresholds:
    the distance slot's per (row tile, centroid tile), factor x max(max
    |col1|, max |row1|, 1) from the expected checksums, and the update
    slot's per row tile, factor(bm) x max(max |valid^T X|, 1)."""
    mp, fp = plan.xp.shape
    kp, bm, bk = cp.shape[0], params.block_m, params.block_k
    nt, nkt = mp // bm, kp // bk
    factor = ops.threshold_factor(fp, dt)
    no_d, no_l = daft.no_injection().cuda(), llft.no_injection().cuda()

    def run_assign(f):
        return int(daft.distance_argmin_ft(plan.xp, cp, cn, no_d, factor=f,
                                           **tiles)[2].sum())

    def run_lloyd(f):
        return int(llft.lloyd_step_ft(plan.xp, cp, cn, no_l, plan.m,
                                      factor=f, **tiles)[2].sum())
    out = {"threshold_factor": factor,
           "distance_argmin_ft_log2": clean_margin_log2(run_assign, factor),
           "lloyd_step_ft_log2": clean_margin_log2(run_lloyd, factor)}
    xf = plan.xp.float()
    cf = cp.float()
    col1 = (xf.view(nt, bm, fp).sum(1) @ cf.T).view(nt, nkt, bk).abs() \
        .amax(-1)
    row1 = (xf @ cf.view(nkt, bk, fp).sum(1).T).view(nt, bm, nkt).abs() \
        .amax(1)
    thr_d = factor * torch.clamp_min(torch.maximum(col1, row1), 1.0)
    thr_u = ops.threshold_factor(bm, dt) * torch.clamp_min(
        xf.view(nt, bm, fp).sum(1).abs().amax(1), 1.0)
    out["min_delta_over_distance_threshold"] = {
        "worst_tile": CAMPAIGN_MIN_DELTA / float(thr_d.max()),
        "median_tile": CAMPAIGN_MIN_DELTA / float(thr_d.median())}
    out["min_delta_over_update_threshold"] = {
        "worst_tile": CAMPAIGN_MIN_DELTA / float(thr_u.max()),
        "median_tile": CAMPAIGN_MIN_DELTA / float(thr_u.median())}
    del xf, cf, col1, row1
    torch.cuda.empty_cache()
    return out


def abft_fault_delta(torch, ops, xg, yg, tiles, tile_ix, dt):
    """(delta, threshold): a fault ABFT_FAULT_OVER_THRESHOLD x the threshold
    of output tile ``tile_ix`` (m-tile, n-tile), rounded up to a power of
    two. The threshold is the kernel's, factor(Kp, dtype) x max(max |col1|,
    max |row1|, 1) from the expected checksums of the tile's inputs."""
    bm, bn, bk = tiles
    i, j = tile_ix
    kp = -(-xg.shape[1] // bk) * bk
    xt = xg[i * bm:(i + 1) * bm].float()
    yt = yg[:, j * bn:(j + 1) * bn].float()
    scale = max(float((xt.sum(0) @ yt).abs().max()),
                float((xt @ yt.sum(1)).abs().max()), 1.0)
    thr = ops.threshold_factor(kp, dt) * scale
    return 2.0 ** math.ceil(math.log2(ABFT_FAULT_OVER_THRESHOLD * thr)), thr


def abft_checks(torch, ops, mma, xg, yg, dt, under: bool,
                tiles=None) -> dict:
    """The ABFT GEMM on xg (m, k) . yg (k, n), both of dtype ``dt`` (f32,
    bf16 or fp16), against the plain product of the same values.
    ``tiles`` None: through ``ops.abft_matmul`` at its own tiles, D
    compared on (m, n); ``tiles``
    (bm, bn, bk): the raw entry ``matmul_abft`` on the padded inputs at those
    tiles (``ops.abft_tiles`` keeps the reference's alignments, k 128, so bk
    32 is reached only there), D compared on (Mp, Np). Clean: no detection,
    D within rtol 1e-5 of the plain version, and a second launch bitwise
    equal (D and the detections per tile). A fault over its tile's
    threshold in a middle tile after a middle k-step at row 7 (or the last
    row), col 31, and with ``tiles`` also in the last tile at its last row
    and column after the first and after the last k-step: one detection,
    every other element within rtol 1e-5 of the clean plain product, the
    corrected one within ABFT_FIX_RTOL |delta| at 2 bytes and within its
    tile's threshold at f32 (the correction holds to the tile's clean
    residual, which the threshold bounds; at f32 that is far over 2^-16
    |delta|). With ``under``, a fault of a 64th of the threshold at the
    middle place: no detection, D off by it there. The encodings pre-pass
    against its plain version (normalised error under 1e-5), and its split
    E_Y (2 bytes) or Y's planes (f32) bitwise their plain split."""
    m, k = xg.shape
    n = yg.shape[1]
    bm, bn, bk = tiles or ops.abft_tiles(m, n, k)
    nt = (-(-m // bm), -(-n // bn), -(-k // bk))
    mp, np_, kp = nt[0] * bm, nt[1] * bn, nt[2] * bk
    xp, yp = ops._pad_to(xg, mp, kp), ops._pad_to(yg, kp, np_)
    factor = ops.threshold_factor(kp, dt)
    no_inj = mma.no_injection().cuda()
    rows, cols = (mp, np_) if tiles else (m, n)

    def run(inj):
        if tiles is None:
            return ops.abft_matmul(xg, yg, inj=inj)
        d, det = mma.matmul_abft(xp, yp, no_inj if inj is None else inj,
                                 block_m=bm, block_n=bn, block_k=bk,
                                 factor=factor)
        return d, det.sum()

    what = f"{dt} abft_matmul {m} x {k} x {n} tiles {(bm, bn, bk)}"
    d, det = run(None)
    pd, pdet = mma.matmul_abft_plain(xp, yp, no_inj, bm, bn, bk, factor)
    pd = pd[:rows, :cols]
    ok, err = rel_ok(d, pd, 1e-5)
    expect(int(det) == 0 and int(pdet.sum()) == 0 and ok,
           f"{what} clean: det {int(det)}, plain det {int(pdet.sum())}, "
           f"err {err}")
    # the comparisons' own launches are not the path's: their counts are
    # put back
    counts = (mma.matmul_abft.launches, mma.abft_encodings.launches)
    r1 = mma.matmul_abft(xp, yp, no_inj, block_m=bm, block_n=bn,
                         block_k=bk, factor=factor)
    r2 = mma.matmul_abft(xp, yp, no_inj, block_m=bm, block_n=bn,
                         block_k=bk, factor=factor)
    expect(all(bool(torch.equal(a, b)) for a, b in zip(r1, r2)),
           f"{what}: two clean launches differ")
    del r1, r2
    ex, ey, esy, *ecol = mma.abft_encodings(xp, yp, block_m=bm, block_n=bn)
    mma.matmul_abft.launches, mma.abft_encodings.launches = counts
    pex, pey, _, *pecol = mma.abft_operands_plain(xp, yp, bm, bn)
    # the encodings, and at f32 the expected column and row checksums
    pairs = [(ex, pex), (ey, pey)] + list(zip(ecol, pecol))
    enc_err = max(max_err(a, b) / max(float(b.abs().max()), 1.0)
                  for a, b in pairs)
    enc_abs = max(max_err(a, b) for a, b in pairs)
    del pairs, ecol, pecol
    # the split of the kernel's own E_Y (2 bytes), or Y's planes (f32): the
    # same rounding, bit for bit
    want_op = (mma.y_planes_plain(yp) if dt == torch.float32
               else mma.split_encodings(ey, bn, dt))
    split_ok = bool(torch.equal(esy, want_op))
    del want_op
    expect(enc_err <= 1e-5 and split_ok,
           f"{what}: encodings off their plain version by {enc_err} "
           f"(normalised), the GEMM's operand bitwise its plain split: "
           f"{split_ok}")
    del ex, ey, esy, pex, pey
    row = min(7, bm - 1)
    places = [(nt[0] // 2, nt[1] // 2, nt[2] // 2, row, 31)]
    if tiles:
        places += [(nt[0] - 1, nt[1] - 1, 0, bm - 1, bn - 1),
                   (nt[0] - 1, nt[1] - 1, nt[2] - 1, bm - 1, bn - 1)]
    out = {"tiles": [bm, bn, bk], "clean_max_abs_err": err,
           "encodings_err": enc_err, "encodings_max_abs_err": enc_abs,
           "faults": []}
    for ti, tj, tk, r, c in places:
        gi, gj = ti * bm + r, tj * bn + c
        delta, thr = abft_fault_delta(torch, ops, xg, yg, (bm, bn, bk),
                                      (ti, tj), dt)
        d_f, det_f = run(mma.make_injection(ti, tj, tk, r, c, delta).cuda())
        fix = abs(float(d_f[gi, gj]) - float(pd[gi, gj]))
        d_f[gi, gj] = pd[gi, gj]
        ok_rest, _ = rel_ok(d_f, pd, 1e-5)
        fix_bound = thr if dt == torch.float32 else ABFT_FIX_RTOL * delta
        expect(int(det_f) == 1 and ok_rest and fix <= fix_bound,
               f"{what}: a fault of {delta} (threshold {thr}) at tile "
               f"{(ti, tj)} k-step {tk} ({r}, {c}) detected {int(det_f)} "
               f"times, corrected element off by {fix}, the rest within "
               f"rtol 1e-5: {ok_rest}")
        out["faults"].append({"at": [ti, tj, tk, r, c], "delta": delta,
                              "tile_threshold": thr,
                              "detected": int(det_f),
                              "corrected_element_err": fix})
        del d_f
    if under:
        ti, tj, tk, r, c = places[0]
        gi, gj = ti * bm + r, tj * bn + c
        small = out["faults"][0]["tile_threshold"] / 64.0
        d_u, det_u = run(mma.make_injection(ti, tj, tk, r, c, small).cuda())
        off = float(d_u[gi, gj]) - float(pd[gi, gj])
        expect(int(det_u) == 0 and abs(off - small) <= 1e-3 * small
               + 1e-5 * float(pd.abs().max()),
               f"{what}: a fault of {small} under the threshold detected "
               f"{int(det_u)} times or D off by {off} there")
        out.update(under_delta=small, under_detected=int(det_u))
        del d_u
    del d, pd, xp, yp
    torch.cuda.empty_cache()
    return out


def abft_times(torch, ops, hw, mma, xg, yg, dt, bound) -> dict:
    """The 2-byte ABFT GEMM's time at xg (m, k) . yg (k, n) beside its
    plain version's, ``torch.matmul`` in the 2-byte dtype (D rounded to 2
    bytes) and its bound: the tensor-core FLOPs or the bytes of 2-byte X and
    Y and the f32 D; and its encodings pre-pass alone beside its plain
    version and its bound (the bytes of X and Y)."""
    m, k = xg.shape
    n = yg.shape[1]
    bm, bn, bk = ops.abft_tiles(m, n, k)
    mp, np_, kp = -(-m // bm) * bm, -(-n // bn) * bn, -(-k // bk) * bk
    xp, yp = ops._pad_to(xg, mp, kp), ops._pad_to(yg, kp, np_)
    factor = ops.threshold_factor(kp, dt)
    no_inj = mma.no_injection().cuda()
    b_ms, b_by = bound(2.0 * m * n * k, 2.0 * (m * k + k * n) + 4.0 * m * n,
                       peak=hw.PEAK_FLOPS_BF16)
    # the encodings pre-pass: X and Y read once, (tiles, Kpe, 2) f32 out;
    # its sums, (m + n) k adds and as many FMAs, are far under the bytes
    kpe = -(-kp // mma.ENC_K_ALIGN) * mma.ENC_K_ALIGN
    e_ms, e_by = bound(4.0 * (m + n) * k, 2.0 * (m * k + k * n)
                       + 8.0 * (mp // bm + np_ // bn) * kpe,
                       peak=hw.PEAK_FLOPS_F32)
    out = {"ms": cuda_ms(lambda: mma.matmul_abft(
               xp, yp, no_inj, block_m=bm, block_n=bn, block_k=bk,
               factor=factor)),
           "plain_ms": cuda_ms(lambda: mma.matmul_abft_plain(
               xp, yp, no_inj, bm, bn, bk, factor), reps=2),
           "library_ms": cuda_ms(lambda: torch.matmul(xg, yg)),
           "bound_ms": b_ms, "bound_by": b_by,
           "encode_ms": cuda_ms(lambda: mma.abft_encodings(
               xp, yp, block_m=bm, block_n=bn)),
           "encode_plain_ms": cuda_ms(lambda: mma.abft_encodings_plain(
               xp, yp, bm, bn), reps=2),
           "encode_bound_ms": e_ms, "encode_bound_by": e_by}
    del xp, yp
    torch.cuda.empty_cache()
    return out


def tile_bound_ok(torch, got, want, xn) -> tuple[bool, float]:
    """The pruned step's tile bounds, sqrt(max(d, 0)) of true squared
    distances d, which cancel the row norms: where the plain version
    computed a cell, the squares agree to rtol 1e-5 of the largest row norm
    (the kernel's and the plain version's f32 sums run in other orders, and
    the root of a small d amplifies that); elsewhere both hold the
    placeholder. Returns (ok, the largest squared difference)."""
    live = want < 3e38
    err = float((got[live].double() ** 2 - want[live].double() ** 2)
                .abs().max()) if bool(live.any()) else 0.0
    ok = bool(torch.equal(got[~live], want[~live]))
    return ok and err <= 1e-5 * max(float(xn.max()), 1.0), err


def phase_lowp_rest_kernels(torch, ops, ll, llp, mma, dtype) -> dict:
    """Phase 14 (a): the 2-byte batched step, pruned step and ABFT GEMM
    against their plain versions and the kernels they must equal; the ABFT
    GEMM also at ABFT_TILE_CASES' tiles."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import update as up
    dt = getattr(torch, dtype)
    out = {"batched": [], "pruned": [], "abft_matmul": []}
    for b, n, f, k in ((7, 10_007, 20, 200), (7, 10_007, 20, 100)):
        x, c = pq_stack(torch, b, n, f, k)
        params = ops.clamp_params(n, k, f, ops.DEFAULT_PARAMS)
        plan, cp, cn, params = ops._resolve_padded_batched(
            ops.plan_data_batched(x.to(dt), params), c, None)
        tiles = dict(block_m=params.block_m, block_k=params.block_k,
                     block_f=params.block_f)
        kp, bm = cp.shape[1], params.block_m
        rec = {"b": b, "n": n, "f": f, "k": k, "tol_rel": 1e-5}
        got = ll.lloyd_step_batched_entries(plan.xp, cp, cn, n, **tiles)
        want = ll.lloyd_step_batched_plain(plan.xp, cp, cn, n, bm)
        ok, rec["min_err"] = rel_ok(got[0], want[0], 1e-5)
        expect(ok, f"{dtype} lloyd_step_batched distances vs plain {rec}")
        near = 0
        for i in range(b):
            near += near_tie_rows(torch, plan.xp[i], cp[i], cn[i], got[1][i],
                                  want[1][i], f"{dtype} lloyd_step_batched "
                                  f"problem {i} K={k}")
            one = ll.lloyd_step(plan.xp[i], cp[i], cn[i], n, **tiles)
            same_problem(torch, up, got, i, one, bm,
                         f"{dtype} batched problem {i} K={k}")
        rec.update(near_tie_labels=near,
                   **batched_entries_control(torch, up, ll, plan.xp, got, kp,
                                             n, bm, f"{dtype} K={k}"))
        out["batched"].append(rec)
        del x, c, plan, got, want, one
        torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 14)
    for k in (1000, 100):
        params = ops.clamp_params(M_SMALL, k, F_SMALL, ops.DEFAULT_PARAMS)
        bm, bk = params.block_m, params.block_k
        tiles = dict(block_m=bm, block_k=bk, block_f=params.block_f)
        rec = {"k": k, "tol_rel": 1e-5}

        def padded(x, c):
            plan, cp, cn, _ = ops._resolve_padded(
                ops.plan_data(x.to(dt), params), c, None)
            xn = F.pad(plan.xn, (0, plan.xp.shape[0] - plan.m)).contiguous()
            return plan, cp, cn, xn

        # a random mask on small integers: every product and sum exact
        xi = rng.integers(-3, 4, size=(M_SMALL, F_SMALL)).astype(np.float32)
        ci = rng.integers(-3, 4, size=(k, F_SMALL)).astype(np.float32)
        plan, cp, cn, xn = padded(torch.from_numpy(xi).cuda(),
                                  torch.from_numpy(ci).cuda())
        nt, nkt = plan.xp.shape[0] // bm, cp.shape[0] // bk
        skip = torch.from_numpy((rng.random((nt, nkt)) < 0.5)
                                .astype(np.int32)).cuda()
        got = llp.lloyd_step_pruned(plan.xp, cp, cn, xn, skip, plan.m, **tiles)
        want = llp.lloyd_step_pruned_plain(plan.xp, cp, cn, xn, skip, plan.m,
                                           bm, bk)
        check_pruned_exact(torch, up, got, want, bm,
                           f"{dtype} lloyd_step_pruned vs plain, random mask "
                           f"K={k}")
        ok, rec["random_min_err"] = rel_ok(got[0], want[0], 1e-5)
        ok2, rec["random_tmin_err"] = rel_ok(got[5], want[4], 1e-5)
        expect(ok and ok2, f"{dtype} lloyd_step_pruned min / tmin vs plain, "
               f"random mask K={k}")
        rec["random_mask_skipped"] = float(skip.float().mean())
        # no skips on blob data: bit for bit the 2-byte lloyd_step
        x_np, _ = make_blobs(M_SMALL, F_SMALL, k, seed=SEED + k)
        x = torch.from_numpy(x_np).cuda()
        c = torch.from_numpy(blob_centers(k, F_SMALL, SEED + k)).cuda()
        plan, cp, cn, xn = padded(x, c)
        zero = torch.zeros_like(skip)
        got = llp.lloyd_step_pruned(plan.xp, cp, cn, xn, zero, plan.m, **tiles)
        one = ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)
        same_entries_step(torch, got, one,
                          f"{dtype} lloyd_step_pruned without skips K={k}")
        want = llp.lloyd_step_pruned_plain(plan.xp, cp, cn, xn, zero, plan.m,
                                           bm, bk)
        ok, rec["no_skip_tmin_sq_err"] = tile_bound_ok(torch, got[5], want[4],
                                                       xn)
        expect(ok, f"{dtype} lloyd_step_pruned tmin vs plain K={k}: squared "
               f"bounds off by {rec['no_skip_tmin_sq_err']}")
        rec["near_tie_labels"] = near_tie_rows(
            torch, plan.xp, cp, cn, got[1], want[1],
            f"{dtype} lloyd_step_pruned K={k}")
        out["pruned"].append(rec)
        del plan, got, want, one, xi, ci
        torch.cuda.empty_cache()
        # the ABFT GEMM at the kernels' product shape, on normal data
        gen = torch.Generator(device=DEV).manual_seed(SEED + k)
        xg = torch.randn(M_SMALL, F_SMALL, generator=gen,
                         device=DEV).to(dt)
        yg = torch.randn(F_SMALL, k, generator=gen, device=DEV).to(dt)
        out["abft_matmul"].append(dict(
            k=k, **abft_checks(torch, ops, mma, xg, yg, dt, under=True)))
        del x, c, xg, yg
        torch.cuda.empty_cache()
    out["abft_tiles"] = []
    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    for tiles, (m, k, n) in ABFT_TILE_CASES:
        xg = torch.randn(m, k, generator=gen, device=DEV).to(dt)
        yg = torch.randn(k, n, generator=gen, device=DEV).to(dt)
        out["abft_tiles"].append(dict(
            m=m, k=k, n=n, **abft_checks(torch, ops, mma, xg, yg, dt,
                                         under=True, tiles=tiles)))
        del xg, yg
        torch.cuda.empty_cache()
    return out


def phase_flash_fp16(torch, fa, attn, hw) -> tuple[dict, list]:
    """Phase 14 (a), fp16 flash attention at internlm2-1.8b's prefill (B =
    4, H = 16, KV = 8, S = 2048, hd = 128, causal) and decode (one query,
    2080 slots, the last 31 cold) shapes: through ``attend`` (the path;
    launches counted, one each on the prefill and decode kernels) against
    the chunked plain math, then the op against the f32 oracle under the
    fp16 bars with a control that must break them, kernel / plain / SDPA
    times and the bounds (as phase 11), and head dims 64 and 256 on both
    kernels. Returns (record, the prefill and decode kernel rows)."""
    import torch.nn.functional as F
    dev, f16 = DEV, torch.float16
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    b, h, kvh, s, hd = LM_BATCH, LM_HEADS, LM_KV_HEADS, LM_PROMPT, LM_HD

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def ratio(got, want, bars):
        d, w = (got.double() - want.double()).abs(), want.double().abs()
        return max(float((d / (a + r * w)).max()) for a, r in bars)

    def oracle(q, k, v, qpos, kpos):
        return fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        qpos, kpos)

    skv = LM_PROMPT + LM_GEN
    kpos_d = torch.arange(skv, dtype=torch.int32, device=dev)
    kpos_d[LM_PROMPT + 1:] = NEG_POS
    qpos_d = torch.tensor([LM_PROMPT], dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    # (B, S, H, hd) layout, as the model calls attend
    qa, ka, va = (draw(b, s, h, hd).to(f16), draw(b, s, kvh, hd).to(f16),
                  draw(b, s, kvh, hd).to(f16))
    qd, kd, vd = (draw(b, 1, h, hd).to(f16), draw(b, skv, kvh, hd).to(f16),
                  draw(b, skv, kvh, hd).to(f16))
    fa.flash_attention.launches = 0
    for key in fa.flash_attention.kernel_launches:
        fa.flash_attention.kernel_launches[key] = 0
    got_p = attn.attend(qa, ka, va, q_positions=pos, kv_positions=pos)
    got_d = attn.attend(qd, kd, vd, q_positions=qpos_d, kv_positions=kpos_d)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    by_kernel = dict(fa.flash_attention.kernel_launches)
    expect(launches == 2 and by_kernel["flash_prefill_kernel"] == 1
           and by_kernel["flash_decode_kernel"] == 1,
           f"fp16 attend launched the flash kernels {by_kernel}, not one "
           f"prefill and one decode")
    rec = {"bars": {"fp16": FLASH_FP16_BARS,
                    "fp16_decode": FLASH_FP16_DECODE_BARS},
           "attend_launches": launches, "attend_by_kernel": by_kernel}
    for name, got, (q, k, v, qp, kp), bars in (
            ("attend_prefill", got_p, (qa, ka, va, pos, pos),
             FLASH_FP16_BARS),
            ("attend_decode", got_d, (qd, kd, vd, qpos_d, kpos_d),
             FLASH_FP16_DECODE_BARS)):
        want = attn._attend_local(q.float(), k.float(), v.float(),
                                  q_positions=qp, kv_positions=kp,
                                  causal=True, window=0, chunk=attn.Q_CHUNK)
        r = ratio(got, want, bars)
        expect(got.dtype == f16 and got.shape == q.shape and r <= 1.0,
               f"fp16 {name} vs the chunked f32 math: {r} x its bar")
        rec[name + "_err_over_bar"] = r
    del got_p, got_d, qa, ka, va, qd, kd, vd
    torch.cuda.empty_cache()

    def qkv(sq, skv_, hd_=hd, b_=b, h_=h, kvh_=kvh):
        q = draw(b_, h_, sq, hd_) * hd_ ** -0.5
        return (q.to(f16), draw(b_, kvh_, skv_, hd_).to(f16),
                draw(b_, kvh_, skv_, hd_).to(f16))
    # prefill: the op against the f32 oracle, the control one key past the
    # causal edge, times, bounds (causal-useful work)
    q, k, v = qkv(s, s)
    got = fa.flash_attention(q, k, v, pos, pos)
    want = oracle(q, k, v, pos, pos)
    r_p = ratio(got, want, FLASH_FP16_BARS)
    expect(got.dtype == f16 and r_p <= 1.0,
           f"fp16 flash prefill: {r_p} x its bar")
    ctrl = ratio(fa.flash_attention(q, k, v, pos, (pos - 1).clamp(min=0)),
                 want, FLASH_FP16_BARS)
    expect(ctrl > 1.0, f"fp16 prefill control: {ctrl} x the bar; the bar "
           f"would not catch the fault")
    flops = 4.0 * b * h * hd * s * (s + 1) / 2
    bytes_p = 2.0 * (2 * b * h * s * hd + 2 * b * kvh * s * hd) + 8.0 * s
    t_ops, t_bytes = flops / hw.PEAK_FLOPS_BF16, bytes_p / hw.HBM_BW
    prefill = {
        "shape": [b, h, kvh, s, s, hd], "err_over_bar": r_p,
        "control_past_causal_edge": ctrl, "max_abs_err": max_err(got, want),
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, pos, pos), reps=20),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, pos,
                                                             pos), reps=2),
        "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=1.0, enable_gqa=True), reps=20),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    prefill["tflops_useful"] = flops / prefill["ms"] / 1e9
    rec["prefill"] = prefill
    del q, k, v, got, want
    torch.cuda.empty_cache()
    # decode: cold slots; the control lets them in
    q, k, v = qkv(1, skv)
    got = fa.flash_attention(q, k, v, qpos_d, kpos_d)
    want = oracle(q, k, v, qpos_d, kpos_d)
    r_d = ratio(got, want, FLASH_FP16_DECODE_BARS)
    expect(r_d <= 1.0, f"fp16 flash decode: {r_d} x its bar")
    ctrl = ratio(fa.flash_attention(q, k, v, qpos_d, kpos_d.clamp(min=0)),
                 want, FLASH_FP16_DECODE_BARS)
    expect(ctrl > 1.0, f"fp16 decode control: {ctrl} x the bar")
    valid = LM_PROMPT + 1
    flops_d = 4.0 * b * h * valid * hd
    bytes_d = 2.0 * (2 * b * h * hd + 2 * b * kvh * valid * hd) \
        + 4.0 * (valid + 1)
    t_ops, t_bytes = flops_d / hw.PEAK_FLOPS_BF16, bytes_d / hw.HBM_BW
    mask = (kpos_d >= 0)[None, :] & (kpos_d[None, :] <= qpos_d[:, None])
    decode = {
        "shape": [b, h, kvh, 1, skv, hd], "err_over_bar": r_d,
        "control_cold_slots_in": ctrl, "max_abs_err": max_err(got, want),
        "ms": queued_ms(lambda: fa.flash_attention(q, k, v, qpos_d, kpos_d)),
        "paced_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, qpos_d,
                                                       kpos_d), reps=20),
        "plain_ms": queued_ms(lambda: fa.flash_attention_plain(
            q, k, v, qpos_d, kpos_d), reps=20),
        "sdpa_ms": queued_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0, enable_gqa=True)),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    decode["gbytes_per_s"] = bytes_d / decode["ms"] / 1e6
    rec["decode"] = decode
    del q, k, v, got, want
    torch.cuda.empty_cache()
    # head dims 64 and 256 on the prefill (ragged) and decode kernels
    errs = {}
    ar = torch.arange(max(skv, 300), dtype=torch.int32, device=dev)
    for hd_ in (64, 256):
        q, k, v = qkv(300, 300, hd_, 1, 8, 4)
        errs[f"prefill_hd{hd_}"] = ratio(fa.flash_attention(
            q, k, v, ar[:300], ar[:300]), oracle(q, k, v, ar[:300],
                                                 ar[:300]), FLASH_FP16_BARS)
        q, k, v = qkv(2, skv, hd_, 2, 8, 2)
        errs[f"decode_hd{hd_}"] = ratio(fa.flash_attention(
            q, k, v, ar[valid - 2:valid], kpos_d), oracle(
                q, k, v, ar[valid - 2:valid], kpos_d), FLASH_FP16_DECODE_BARS)
    expect(max(errs.values()) <= 1.0, f"fp16 flash head dims: {errs}")
    rec["head_dims_err_over_bar"] = errs
    common = {"route": "cuda",
              "source": "src/repro_torch/csrc/fk_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:76"}
    rows = [dict(common, name="flash_attention_fp16",
                 launches=by_kernel["flash_prefill_kernel"],
                 max_abs_err=prefill["max_abs_err"], ms=prefill["ms"],
                 plain_ms=prefill["plain_ms"], bound_ms=prefill["bound_ms"],
                 bound_by=prefill["bound_by"], library_ms=prefill["sdpa_ms"]),
            dict(common, name="flash_attention_decode_fp16",
                 launches=by_kernel["flash_decode_kernel"],
                 max_abs_err=decode["max_abs_err"], ms=decode["ms"],
                 plain_ms=decode["plain_ms"], bound_ms=decode["bound_ms"],
                 bound_by=decode["bound_by"], library_ms=decode["sdpa_ms"])]
    return rec, rows


def phase_lowp_rest(torch, ops, hw, ll, llp, mma, fa, attn, KMeans,
                    BatchedKMeans, FaultPolicy, x, labels_true, c_init,
                    bound) -> tuple[dict, list]:
    """Phase 14: the rest of the 2-byte variants at bf16 and fp16. (a) the
    kernels against their plain versions (and fp16 flash), (b)
    ``BatchedKMeans`` at the PQ shape bit for bit 48 single 2-byte ``lloyd``
    fits, (c) ``lloyd_pruned`` at the phase-3 shape with rows sorted by
    label bit for bit the 2-byte ``lloyd`` fit, (d) ``FaultPolicy.detect()``
    and the 2-byte ABFT GEMM at phase 10's shapes, (e) the kernels' rows.
    Each path's launches are counted from zero just before it runs."""
    import torch.nn.functional as F
    from repro_torch.core.kmeans import means_from_sums
    from repro_torch.kernels import update as up
    rec = {"phase": 14}
    rows = []
    rec_f, rows_f = phase_flash_fp16(torch, fa, attn, hw)
    rec["flash_fp16"] = rec_f
    rows.extend(rows_f)
    base = dict(n_clusters=K_FULL, max_iter=ITERS, tol=0.0, random_state=SEED)
    params = ops.clamp_params(M_FULL, K_FULL, F_FULL, ops.DEFAULT_PARAMS)
    bm, bk = params.block_m, params.block_k
    tiles = dict(block_m=bm, block_k=bk, block_f=params.block_f)
    kp = -(-K_FULL // bk) * bk
    # the PQ stack and its fused seeds (f32, as the reference seeds)
    xq, _ = pq_stack(torch, B_PQ, N_PQ, F_PQ, K_PQ)
    pq_base = dict(n_clusters=K_PQ, random_state=SEED)
    seeds = BatchedKMeans(init="kmeans++-fused", **pq_base).init_centroids(xq)
    # rows sorted by generating label, seeded by each label's first row
    order = torch.argsort(labels_true, stable=True)
    xs, lab = x[order].contiguous(), labels_true[order]
    first = torch.searchsorted(lab, torch.arange(K_FULL, device=lab.device,
                                                 dtype=lab.dtype))
    seeds_s = xs[first]
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    xb = torch.randn(LM_TOKENS, LM_D_MODEL, generator=gen, device=DEV)
    wb = torch.randn(LM_D_MODEL, LM_D_FF, generator=gen,
                     device=DEV) / math.sqrt(LM_D_MODEL)
    m_f = float(M_FULL * F_FULL)
    for dtype, tag in (("bfloat16", "bf16"), ("float16", "fp16")):
        dt = getattr(torch, dtype)
        r = {"kernels": phase_lowp_rest_kernels(torch, ops, ll, llp, mma,
                                                dtype)}
        # --- (b) BatchedKMeans at the PQ shape: the entries route and the
        # tree over them, with no dense launch
        ll.lloyd_step_batched_entries.launches = 0
        ll.lloyd_step_batched.launches = 0
        up.tree_reduce.kernel_launches.update(sparse=0, dense=0)
        bkm, fit_s = wall(lambda: BatchedKMeans(
            max_iter=PQ_ITERS, tol=0.0, compute_dtype=dtype, **pq_base)
            .fit(xq, centroids=seeds))
        labels = bkm.predict(xq)
        score = bkm.score(xq)
        torch.cuda.synchronize()
        launches_b = ll.lloyd_step_batched_entries.launches
        tree_kinds = dict(up.tree_reduce.kernel_launches)
        expect(launches_b > 0 and ll.lloyd_step_batched.launches == 0
               and tree_kinds["sparse"] > 0 and tree_kinds["dense"] == 0,
               f"{dtype} batched path: {launches_b} entries launches, "
               f"{ll.lloyd_step_batched.launches} dense, trees {tree_kinds}")
        fit_peak = peak_gb(lambda: BatchedKMeans(
            max_iter=2, tol=0.0, compute_dtype=dtype, **pq_base)
            .fit(xq, centroids=seeds))
        singles = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(B_PQ):
            singles.append(KMeans(K_PQ, backend="lloyd", max_iter=PQ_ITERS,
                                  tol=0.0, compute_dtype=dtype,
                                  random_state=SEED + i)
                           .fit(xq[i], centroids=seeds[i]))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        for i, one in enumerate(singles):
            expect(bool(torch.equal(one.cluster_centers_,
                                    bkm.cluster_centers_[i]))
                   and bool(torch.equal(one.labels_, bkm.labels_[i])),
                   f"{dtype} batched problem {i} is not bit for bit its "
                   f"single fit")
            expect(bool(torch.equal(one.predict(xq[i]), labels[i])),
                   f"{dtype} batched predict of problem {i} differs from "
                   f"its single fit")
        expect(bkm.cluster_centers_.dtype == torch.float32
               and bool(torch.isfinite(bkm.cluster_centers_).all())
               and bool((torch.from_numpy(score) < 0).all()),
               f"{dtype} batched centroids not finite f32, or score {score}")
        r["batched"] = {"b": B_PQ, "n": N_PQ, "f": F_PQ, "k": K_PQ,
                        "batched_ms_per_iter": 1e3 * fit_s / PQ_ITERS,
                        "single_loop_ms_per_iter": 1e3 * loop_s / PQ_ITERS,
                        "singles_bitwise": B_PQ,
                        "score_sum": float(score.sum()),
                        "n_host_syncs": bkm._n_host_syncs,
                        "launches": launches_b,
                        "tree_reduce_variants": tree_kinds,
                        "fit_peak_gb_past_x": fit_peak}
        del singles, bkm, labels
        torch.cuda.empty_cache()
        # --- (c) lloyd_pruned at the phase-3 shape, rows sorted by label
        llp.lloyd_step_pruned.launches = 0
        km_apr, apr_s = wall(lambda: KMeans(
            backend="lloyd_pruned", compute_dtype=dtype, **base)
            .fit(xs, centroids=seeds_s))
        torch.cuda.synchronize()
        launches_p = llp.lloyd_step_pruned.launches
        expect(launches_p > 0, f"{dtype} lloyd_step_pruned was not launched "
               f"on the pruned path")
        km_all, all_s = wall(lambda: KMeans(
            backend="lloyd", compute_dtype=dtype, **base)
            .fit(xs, centroids=seeds_s))
        expect(bool(torch.equal(km_apr.cluster_centers_,
                                km_all.cluster_centers_))
               and bool(torch.equal(km_apr.labels_, km_all.labels_)),
               f"{dtype} lloyd_pruned fit is not bit for bit the lloyd fit")
        hist = km_apr.prune_history_
        third = hist[-max(1, len(hist) // 3):]
        expect(len(hist) == km_apr.n_iter_ and hist[0] == 0.0
               and min(third) >= 0.5,
               f"{dtype} aligned pruning below 50 % in the last third: "
               f"{hist}")
        r["pruned"] = {"lloyd_pruned_ms_per_iter": 1e3 * apr_s / ITERS,
                       "lloyd_ms_per_iter": 1e3 * all_s / ITERS,
                       "prune_history": hist, "launches": launches_p}
        del km_apr, km_all
        torch.cuda.empty_cache()
        # --- (d) detect fit from phase 3's seeds, and the ABFT GEMM at
        # phase 10's shapes
        mma.matmul_abft.launches = 0
        mma.abft_encodings.launches = 0
        km_det, det_s = wall(lambda: KMeans(
            fault=FaultPolicy.detect(), compute_dtype=dtype, **base)
            .fit(x, centroids=c_init))
        det_labels = km_det.predict(x)
        det_score = km_det.score(x)
        ya = km_det.cluster_centers_.T.contiguous()
        r["abft_matmul_a"] = abft_checks(torch, ops, mma, x.to(dt),
                                         ya.to(dt), dt, under=True)
        r["abft_matmul_b"] = abft_checks(torch, ops, mma, xb.to(dt),
                                         wb.to(dt), dt, under=True)
        torch.cuda.synchronize()
        launches_m = mma.matmul_abft.launches
        launches_e = mma.abft_encodings.launches
        expect(launches_m > 0 and launches_e == launches_m,
               f"{dtype} matmul_abft launched {launches_m} times, its "
               f"encodings pre-pass {launches_e}")
        km_f, f_s = wall(lambda: KMeans(compute_dtype=dtype, **base)
                         .fit(x, centroids=c_init))
        # the detect fit's distances are 2-byte (the reference's arithmetic),
        # so labels near a tie move and the fit may settle in another
        # optimum: the exact f32 inertia of its centroids is held one-sided
        # to the fused fit's of its dtype (the int8 fit's bar), its labels
        # reported
        agree = float((km_det.labels_ == km_f.labels_).float().mean())
        xn = (x * x).sum(1)
        exact_det, exact_f = (
            float((ops.fused_assign(x, c)[1] + xn).sum())
            for c in (km_det.cluster_centers_, km_f.cluster_centers_))
        del xn
        expect(km_det._backend.name == "abft_offline"
               and exact_det <= (1.0 + INT8_INERTIA_RTOL) * exact_f,
               f"{dtype} detect fit ({km_det._backend.name}): exact inertia "
               f"{exact_det} vs the fused fit's {exact_f}")
        # at fp16 the reference's arithmetic overflows: the checksums of
        # thousands of rows pass fp16's 65504 (the e2 weights alone do past
        # 65504 rows), so a residual is inf and one element a product is
        # "corrected" to NaN, in both packages; the score is then NaN
        overflow = dtype == "float16" and math.isnan(det_score)
        expect(bool(torch.isfinite(km_det.cluster_centers_).all())
               and det_labels.shape == (M_FULL,)
               and int(det_labels.min()) >= 0
               and int(det_labels.max()) < K_FULL
               and (det_score < 0 or overflow),
               f"{dtype} detect predict/score out of range ({det_score})")
        r["detect"] = {
            "detect_ms_per_iter": 1e3 * det_s / km_det.n_iter_,
            "fused_ms_per_iter": 1e3 * f_s / km_f.n_iter_,
            "detected_errors": km_det.detected_errors_,
            "label_agreement_with_fused": agree,
            "exact_inertia": exact_det, "fused_exact_inertia": exact_f,
            "inertia": km_det.inertia_, "fused_inertia": km_f.inertia_,
            "score": det_score, "fp16_checksum_overflow": overflow,
            "n_host_syncs": km_det._n_host_syncs,
            "matmul_abft_launches": launches_m,
            "abft_encode_launches": launches_e}
        del km_det, km_f, det_labels
        torch.cuda.empty_cache()

        # --- (e) the rows. The batched step at the PQ shape
        pq_params = ops.clamp_params(N_PQ, K_PQ, F_PQ, ops.DEFAULT_PARAMS)
        plan, cp, cn, _ = ops._resolve_padded_batched(
            ops.plan_data_batched(xq.to(dt), pq_params), seeds, None)
        pq_tiles = dict(block_m=pq_params.block_m, block_k=pq_params.block_k,
                        block_f=pq_params.block_f)
        b_, np_, fp = plan.xp.shape
        nt = np_ // pq_params.block_m
        cn_lo = cn.to(dt)

        def batched():
            return ll.lloyd_step_batched_entries(plan.xp, cp, cn, N_PQ,
                                                 **pq_tiles)

        def batched_plain():
            return ll.lloyd_step_batched_plain(plan.xp, cp, cn, N_PQ,
                                               pq_params.block_m)
        # labels against the plain version's but for near ties, distances
        # to rtol 1e-5, the entries' tree bit for bit the dense route on the
        # kernel's own labels (with its control), sums to rtol 1e-5 of the
        # plain version's on its labels
        k_out, p_out = batched(), batched_plain()
        ok, b_err = rel_ok(k_out[0], p_out[0], 1e-5)
        expect(ok, f"{dtype} lloyd_step_batched distances vs plain at the "
               f"PQ shape")
        near = 0
        for i in range(b_):
            near += near_tie_rows(torch, plan.xp[i], cp[i], cn[i],
                                  k_out[1][i], p_out[1][i],
                                  f"{dtype} lloyd_step_batched problem {i} "
                                  f"at the PQ shape")
        ctl = batched_entries_control(torch, up, ll, plan.xp, k_out,
                                      cp.shape[1], N_PQ, pq_params.block_m,
                                      f"{dtype} at the PQ shape")
        sums, counts = batched_sums(up, k_out, pq_params.block_m)
        valid = (torch.arange(np_, device=x.device) < N_PQ).view(
            nt, pq_params.block_m)
        for i in range(b_):
            s_p, c_p = ll.tile_update_plain(
                plan.xp[i].view(nt, pq_params.block_m, fp),
                k_out[1][i].view(nt, pq_params.block_m), valid, cp.shape[1])
            ok, e = rel_ok(sums[i], s_p.sum(0), 1e-5)
            expect(ok and bool(torch.equal(counts[i], c_p.sum(0))),
                   f"{dtype} lloyd_step_batched problem {i} sums/counts vs "
                   f"the plain update at the PQ shape")
            b_err = max(b_err, e)
        present = ctl["present_entries"]
        r["batched"].update(near_tie_labels_row=near,
                            entries_vs_dense=ctl)
        del p_out, s_p, c_p, valid, sums, counts
        # the step's peak past X: the entries route against the dense
        # blocks the parent wrote, (B, T, Kp, Fp) + (B, T, Kp) f32
        kp_pq = cp.shape[1]
        r["batched"]["step_peak_gb_past_x"] = peak_gb(batched)
        r["batched"]["dense_partials_gb"] = 4.0 * b_ * nt * kp_pq * (
            fp + 1) / 1e9
        # the kernel and the tree over its entries, timed apart
        entries, ecnt, idx = k_out[2:]
        del k_out

        def tree():
            return up.reduce_entries(entries, ecnt, idx, ntiles=nt)
        lev = 1 << up.tree_levels(nt)
        t_ms, t_by = bound(float(present) * (F_PQ + 1),
                           4.0 * (present * (F_PQ + 1) + B_PQ * K_PQ * lev
                                  + B_PQ * K_PQ * (F_PQ + 1)))
        r["batched"]["tree_over_entries"] = {
            "ms": cuda_ms(tree, reps=20), "bound_ms": t_ms, "bound_by": t_by,
            "present_entries": present,
            "present_per_tile": present / (b_ * nt)}
        del entries, ecnt, idx
        # the bound: 2-byte X and C read once, the labels and minima
        # written, the present entries and their counts written, idx
        # written (the true K; padded figures beside); the GEMM at the true
        # K and F on the 2-byte tensor cores
        bq = float(B_PQ)
        b_ms, b_by = bound(
            2.0 * bq * N_PQ * K_PQ * F_PQ + bq * N_PQ * F_PQ,
            2.0 * bq * (N_PQ + K_PQ) * F_PQ + 4.0 * bq * K_PQ
            + 8.0 * bq * N_PQ + 4.0 * present * (F_PQ + 1)
            + 4.0 * bq * K_PQ * lev,
            peak=hw.PEAK_FLOPS_BF16)
        b_ms_ = cuda_ms(batched, reps=20)
        r["batched"]["kernel_ms"] = b_ms_
        r["batched"]["kernel_and_tree_ms"] = (
            b_ms_ + r["batched"]["tree_over_entries"]["ms"])
        rows.append({"name": f"lloyd_step_batched_{tag}", "route": "cuda",
                     "source": "src/repro_torch/csrc/fk_kernels.cu",
                     "replaces": "src/repro/kernels/lloyd_step.py:278",
                     "launches": launches_b, "max_abs_err": b_err,
                     "ms": b_ms_,
                     "plain_ms": cuda_ms(batched_plain, reps=3),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": cuda_ms(lambda: torch.baddbmm(
                         cn_lo[:, None, :], plan.xp, cp.transpose(1, 2),
                         alpha=-2.0).min(dim=2), reps=20)})
        del plan, cp, cn, cn_lo
        torch.cuda.empty_cache()
        # the pruned step at the sorted fit's step-3 mask
        plan = ops.plan_data(xs.to(dt), params)
        c, bounds = seeds_s, None
        for _ in range(2):
            _, _, sums, counts, bounds, _ = ops.fused_lloyd_pruned(
                plan, c, params, bounds=bounds)
            c = means_from_sums(sums, counts, c)
        _, cp, cn, _ = ops._resolve_padded(plan, c, params)
        skip, _ = ops.prune_mask(bounds, cp, plan.m, params)
        skip = skip.contiguous()
        mp, fp = plan.xp.shape
        nt, nkt = mp // bm, kp // bk
        xn = F.pad(plan.xn, (0, mp - plan.m)).contiguous()
        computed = int((skip == 0).sum())
        ar = torch.arange(max(nt, nkt), device=skip.device)
        rows_in = (plan.m - ar[:nt] * bm).clamp(max=bm)
        cols_in = (K_FULL - ar[:nkt] * bk).clamp(max=bk)
        cells = float(((skip == 0) * rows_in[:, None]
                       * cols_in[None, :]).sum())

        def pruned():
            return llp.lloyd_step_pruned(plan.xp, cp, cn, xn, skip, plan.m,
                                         **tiles)

        def pruned_plain():
            return llp.lloyd_step_pruned_plain(plan.xp, cp, cn, xn, skip,
                                               plan.m, bm, bk)
        k_out, p_out = pruned(), pruned_plain()
        n_present = int((k_out[4] >= 0).sum())
        r["pruned"]["near_tie_labels_row"] = near_tie_rows(
            torch, plan.xp, cp, cn, k_out[1], p_out[1],
            f"{dtype} lloyd_step_pruned at the phase-3 shape")
        k_out, p_out = pruned_canon(up, k_out, bm), pruned_canon(up, p_out,
                                                                 bm)
        pr_err = max(max_err(a, b) for a, b in zip(k_out, p_out)
                     if a.is_floating_point())
        del k_out, p_out
        torch.cuda.empty_cache()
        r["pruned"]["row_skipped"] = 1.0 - computed / (nt * nkt)
        r["pruned"]["step_peak_gb_past_x"] = peak_gb(pruned)
        r["pruned"]["present_entries"] = n_present
        r["pruned"]["no_skip_ms"] = cuda_ms(
            lambda: llp.lloyd_step_pruned(plan.xp, cp, cn, xn,
                                          torch.zeros_like(skip), plan.m,
                                          **tiles))
        r["pruned"]["lloyd_step_same_inputs_ms"] = cuda_ms(
            lambda: ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles))
        cn_lo = cn.to(dt)
        lib_ms = cuda_ms(lambda: torch.addmm(
            cn_lo[None, :], plan.xp, cp.T, beta=1.0, alpha=-2.0).min(dim=1))
        b_ms, b_by = bound(2.0 * cells * F_FULL + m_f,
                           2.0 * m_f + 2.0 * K_FULL * F_FULL + 12.0 * M_FULL
                           + entry_bytes(n_present, F_FULL, K_FULL, nt)
                           + 8.0 * nt * nkt, peak=hw.PEAK_FLOPS_BF16)
        rows.append({"name": f"lloyd_step_pruned_{tag}", "route": "cuda",
                     "source": "src/repro_torch/csrc/fk_kernels.cu",
                     "replaces": "src/repro/kernels/lloyd_step_pruned.py:189",
                     "launches": launches_p, "max_abs_err": pr_err,
                     "ms": cuda_ms(pruned),
                     "plain_ms": cuda_ms(pruned_plain, reps=2),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
        del plan, cp, cn, cn_lo, xn, skip, bounds, sums, counts
        torch.cuda.empty_cache()
        # the ABFT GEMM at phase 10's shapes: the row is shape (a)
        for key, (xg, yg) in (("a", (x, ya)), ("b", (xb, wb))):
            r[f"abft_matmul_{key}"].update(abft_times(
                torch, ops, hw, mma, xg.to(dt), yg.to(dt), dt, bound))
        g = r["abft_matmul_a"]
        rows.append({"name": f"matmul_abft_{tag}", "route": "cuda",
                     "source": "src/repro_torch/csrc/fk_abft_gemm.cu",
                     "replaces": "src/repro/kernels/matmul_abft.py:127",
                     "launches": launches_m,
                     "max_abs_err": g["clean_max_abs_err"], "ms": g["ms"],
                     "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
                     "bound_by": g["bound_by"],
                     "library_ms": g["library_ms"]})
        rows.append({"name": f"abft_encode_{tag}", "route": "cuda",
                     "source": "src/repro_torch/csrc/fk_abft_gemm.cu",
                     "replaces": "src/repro/kernels/matmul_abft.py:127",
                     "launches": launches_e,
                     "max_abs_err": g["encodings_max_abs_err"],
                     "ms": g["encode_ms"], "plain_ms": g["encode_plain_ms"],
                     "bound_ms": g["encode_bound_ms"],
                     "bound_by": g["encode_bound_by"], "library_ms": None})
        del ya
        torch.cuda.empty_cache()
        emit(dict(phase=14, dtype=dtype, **r))
    rec["library_calls"] = {
        "lloyd_step_batched": "baddbmm(cn, X, C^T, alpha=-2) + min(dim=2) "
                              "in the 2-byte dtype: distances and labels, "
                              "no update",
        "lloyd_step_pruned": "addmm(cn, X, C^T, alpha=-2) + min(dim=1) in "
                             "the 2-byte dtype: every tile",
        "matmul_abft": "torch.matmul(X, Y) in the 2-byte dtype: unprotected, "
                       "D rounded to 2 bytes",
        "flash_attention_fp16": "F.scaled_dot_product_attention at fp16",
        "flash_attention_decode_fp16": "F.scaled_dot_product_attention at "
                                       "fp16 with the boolean mask"}
    del xq, seeds, xs, lab, seeds_s, xb, wb
    torch.cuda.empty_cache()
    return rec, rows


# --- phase 15: mini-batch fits, the Hopper autotune table, k-means serving --

def counts_of(wrappers: dict) -> dict:
    return {name: w.launches for name, w in wrappers.items()}


def add_counts(total: dict, tag: str, counts: dict, scale: int = 1) -> None:
    """Add launch counts to ``total`` under the kernels line's row names
    (a 2-byte path's rows end in ``_bf16``; the tree and the FT update's
    verification, f32 kernels at every X dtype, keep theirs)."""
    for name, n in counts.items():
        key = f"{name}_{tag}" if tag and name not in (
            "tree_reduce", "verify_entries") else name
        total[key] = total.get(key, 0) + scale * n


def hand_minibatch(torch, np, ops, km_mod, fault_mod, km, x, c0) -> list:
    """``km``'s mini-batch fit driven by hand: each step draws numpy's
    batch (``default_rng(random_state + 1).choice(M, B, replace=False)``),
    plans it at the table's tiles for the batch (quantised for int8), runs
    the fit's backend wrapper with a disarmed descriptor and updates.
    Returns each step's centroids."""
    rng = np.random.default_rng(km.random_state + 1)
    backend = km._backend
    m, f = x.shape
    kind = backend.kernel_kind if backend.takes_params else "assign"
    p = ops.clamp_params(MB_BATCH, K_FULL, F_FULL, km.autotune.lookup(
        MB_BATCH, K_FULL, F_FULL, kind=kind, dtype=km.compute_dtype)[1])
    int8 = km.compute_dtype == torch.int8
    cast = torch.float32 if int8 else km.compute_dtype
    c, steps = c0, []
    for _ in range(km.n_iter_):
        idx = rng.choice(m, MB_BATCH, replace=False)
        batch = x[torch.from_numpy(idx).to(x.device)]
        plan = ops.plan_data_int8(batch, p) if int8 \
            else ops.plan_data(batch.to(cast), p)
        kw = {"params": p} if backend.takes_params else {}
        if backend.takes_injection:
            kw["inj"] = fault_mod.no_step_injection(
                backend.kernel_kind).to(x.device)
        out = backend(plan, c.to(cast), **kw)
        if backend.fuses_update:
            c = km_mod.means_from_sums(out[3], out[4], c)
        else:
            c = km_mod.centroid_update(plan, out[0], K_FULL, c,
                                       use_dmr=km._use_dmr)[0]
        steps.append(c)
    return steps


def phase_minibatch(torch, np, ops, KMeans, FaultPolicy, InjectionCampaign,
                    x, c_init, wrappers) -> tuple[dict, dict]:
    """Phase 15 (a): ``KMeans(batch_size=MB_BATCH)`` fits on phase 3's data
    from phase 3's seeds, ``MB_ITERS`` steps at tol = 0: ``fused``,
    ``lloyd``, ``lloyd_ft`` clean and under a campaign, int8, ``detect``
    and bf16 ``lloyd``. Each step's centroids bit for bit a hand-driven
    loop of the same wrapper over numpy's batches (so the fit drew numpy's
    indices), clean ``lloyd_ft`` detects 0, the campaign > 0 with the clean
    fit's centroids, ``labels_`` = ``predict(X)``. ms/iter (the final
    predict over X included) is a reading. Returns the record and the fits'
    launches by row name."""
    from repro_torch.core import fault as fault_mod
    from repro_torch.core import kmeans as km_mod
    camp = FaultPolicy.correct(injection=InjectionCampaign(rate=1.0,
                                                           targets="both"))
    cases = {"fused": dict(), "lloyd": dict(backend="lloyd"),
             "lloyd_ft": dict(fault=FaultPolicy.correct()),
             "campaign": dict(fault=camp), "int8": dict(compute_dtype="int8"),
             "detect": dict(fault=FaultPolicy.detect()),
             "lloyd_bf16": dict(backend="lloyd", compute_dtype="bfloat16")}
    base = dict(n_clusters=K_FULL, max_iter=MB_ITERS, tol=0.0,
                batch_size=MB_BATCH, random_state=SEED)
    rec = {"phase": 15, "part": "a: mini-batch fits", "m": M_FULL,
           "f": F_FULL, "k": K_FULL, "batch": MB_BATCH, "iters": MB_ITERS}
    launches: dict = {}
    fits = {}
    for name, kw in cases.items():
        for w in wrappers.values():
            w.launches = 0
        steps = []
        km, fit_s = wall(lambda: KMeans(**base, **kw).fit(
            x, centroids=c_init,
            on_iteration=lambda it, c, *_: steps.append(c.clone())))
        add_counts(launches, "bf16" if name.endswith("bf16") else "",
                   counts_of(wrappers))
        # host-clock readings swing between runs: three more fits, median
        again = sorted(wall(lambda: KMeans(**base, **kw).fit(
            x, centroids=c_init))[1] for _ in range(3))
        r = {"ms_per_iter": 1e3 * again[1] / km.n_iter_,
             "ms_per_iter_runs": [1e3 * t / km.n_iter_
                                  for t in (fit_s, *again)],
             "n_iter": km.n_iter_, "inertia": km.inertia_,
             "detected": km.detected_errors_,
             "host_syncs": km._n_host_syncs}
        if name != "campaign":
            hand = hand_minibatch(torch, np, ops, km_mod, fault_mod, km, x,
                                  c_init)
            r["steps_bitwise_hand_loop"] = len(hand) == len(steps) == \
                MB_ITERS and all(bool(torch.equal(a, b))
                                 for a, b in zip(steps, hand))
            expect(r["steps_bitwise_hand_loop"],
                   f"mini-batch {name}: a step's centroids are not bit for "
                   f"bit the hand-driven loop over numpy's batches")
            del hand
        r["labels_equal_predict"] = bool(torch.equal(km.labels_,
                                                      km.predict(x)))
        expect(r["labels_equal_predict"],
               f"mini-batch {name}: labels_ differ from predict(X)")
        expect(bool(torch.isfinite(km.cluster_centers_).all()),
               f"mini-batch {name}: centroids not finite")
        rec[name] = r
        fits[name] = km
        del steps
        torch.cuda.empty_cache()
    # where a step's time goes: numpy's draw on the host, and a trace of
    # the lloyd and int8 fits (kernels, device-busy share)
    draw_rng = np.random.default_rng(SEED + 1)
    draws = []
    for _ in range(5):
        t0 = time.perf_counter()
        draw_rng.choice(M_FULL, MB_BATCH, replace=False)
        draws.append(1e3 * (time.perf_counter() - t0))
    rec["numpy_draw_ms"] = sorted(draws)[2]
    for name in ("lloyd", "int8"):
        rec[f"trace_{name}"] = device_trace(torch, lambda: KMeans(
            **base, **cases[name]).fit(x, centroids=c_init))
    expect(fits["lloyd_ft"].detected_errors_ == 0,
           f"clean mini-batch lloyd_ft detected "
           f"{fits['lloyd_ft'].detected_errors_}")
    expect(fits["campaign"].detected_errors_ > 0,
           "the mini-batch campaign detected nothing")
    rec["campaign_bitwise_clean"] = bool(torch.equal(
        fits["campaign"].cluster_centers_, fits["lloyd_ft"].cluster_centers_))
    expect(rec["campaign_bitwise_clean"], "mini-batch campaign centroids are "
           "not bit for bit the clean lloyd_ft fit's")
    rec["lloyd_bitwise_fused"] = bool(torch.equal(
        fits["lloyd"].cluster_centers_, fits["fused"].cluster_centers_))
    expect(rec["lloyd_bitwise_fused"], "mini-batch lloyd centroids are not "
           "bit for bit the fused fit's")
    return rec, launches


def graph_replay_us(torch, n: int = 200) -> float:
    """Median host time of one replay of a one-kernel CUDA graph and a
    synchronise: the serve model's per-launch constant."""
    buf = torch.zeros(1, device=DEV)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        buf.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        buf.add_(1.0)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1e6 * times[n // 2]


def phase_autotune(torch, ops, hw, da, dai) -> dict:
    """Phase 15 (b): ``measure_score`` of every candidate of the assign,
    lloyd, lloyd_ft, serve and init kinds at f32 and bf16, at the full shape
    and at the serve buckets, beside the model's winner (both must be built
    tiles); the measured table written to a temporary file and read back;
    the model's lookup at phases 3 / 7 / 13's shapes = today's tiles; the
    shared-memory model against the kernels' own bytes; the serve model's
    per-launch constant measured."""
    import tempfile
    from repro_torch.api import AutotuneCache
    from repro_torch.core import autotune as at
    today = ops.DEFAULT_PARAMS
    rec = {"phase": 15, "part": "b: autotune"}
    shapes = [(M_FULL, K_FULL, F_FULL)] + [(b, K_FULL, F_FULL)
                                           for b in SERVE_BUCKETS]
    table, agree, total = {}, 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "autotune_table.json")
        measured = AutotuneCache(path)
        for dtype in ("float32", "bfloat16"):
            for kind in ("assign", "lloyd", "lloyd_ft", "serve", "init"):
                for m, k, f in shapes:
                    ms = {}
                    for p in at.parameter_space(dtype, kind):
                        if at.feasible(p, dtype, kind=kind, shape=(m, k, f)):
                            ms[p] = 1e3 * at.measure_score(
                                m, k, f, p, dtype=dtype, kind=kind)
                    won = min(ms, key=ms.get)
                    variant, model = at.select_params(m, k, f, kind=kind,
                                                      dtype=dtype)
                    for p in (won, model):
                        if kind == "init":
                            expect(p.block_m == hw.INIT_BLOCK_N,
                                   f"init winner {p} is not the built row "
                                   f"tile")
                        else:
                            ops.check_cuda_params(ops.clamp_params(m, k, f,
                                                                   p))
                    measured.put(m, k, f, won, kind=kind, dtype=dtype,
                                 variant=variant)
                    same = ops.clamp_params(m, k, f, won) == \
                        ops.clamp_params(m, k, f, model)
                    agree += same
                    total += 1
                    table[f"{kind}/{dtype}/{m}"] = {
                        "ms": {f"bm{p.block_m}": v for p, v in ms.items()},
                        "measured": ops.clamp_params(m, k, f, won).block_m,
                        "model": ops.clamp_params(m, k, f, model).block_m,
                        "model_ms": 1e3 * at.model_score(
                            m, k, f, model, dtype=dtype, kind=kind),
                        "agree": same}
                    torch.cuda.empty_cache()
        measured.save()
        loaded = AutotuneCache(path)
        for key, r in table.items():
            kind, dtype, m = key.split("/")
            got = loaded.lookup(int(m), K_FULL, F_FULL, kind=kind,
                                dtype=dtype)[1]
            expect(ops.clamp_params(int(m), K_FULL, F_FULL, got).block_m
                   == r["measured"], f"the saved table lost {key}")
    rec["candidates"] = table
    rec["model_agrees"] = f"{agree} of {total}"
    # the invariant: at phases 3 / 7 / 13's shapes the model keeps today's
    # tiles, so those phases launch what the parent launched
    cache = AutotuneCache()
    checks = [(kind, dt, M_FULL, K_FULL, F_FULL, 1)
              for dt in ("float32", "bfloat16", "float16")
              for kind in ("assign", "lloyd", "lloyd_ft", "pruned")]
    checks += [("batched", dt, N_PQ, K_PQ, F_PQ, B_PQ)
               for dt in ("float32", "bfloat16", "float16")]
    checks += [("lloyd", "float32", N_PQ, K_PQ, F_PQ, 1),
               ("int8", "int8", M_FULL, K_FULL, F_FULL, 1)]
    for kind, dt, m, k, f, b in checks:
        got = cache.lookup(m, k, f, kind=kind, dtype=dt, batch=b)[1]
        expect(ops.clamp_params(m, k, f, got) == ops.clamp_params(
            m, k, f, today), f"the model moved {kind}/{dt} at {(m, k, f)} "
            f"to {got}")
    rec["invariant_shapes"] = len(checks)
    # the shared-memory model against the kernels' own bytes at Fp 128
    smem = {}
    for bm in hw.SUPPORTED_BLOCK_M:
        for dt, code in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for kind, ft, upd in (("assign", False, 0), ("lloyd_ft", True, 2),
                                  ("pruned", False, 4)):
                got = da.tile_resources(bm, ft, upd, 128, kp=1024,
                                        dtype=dt)["smem_bytes"]
                want = at.tile_smem_bytes(bm, 128, kind=kind, kp=1024,
                                          dtype=dt)
                smem[f"{kind}_{code}_bm{bm}"] = got
                expect(got == want, f"tile_smem_bytes {kind} {code} bm {bm}:"
                       f" model {want}, kernel {got}")
        got = dai.resources(bm, 128)["smem_bytes"]
        smem[f"int8_bm{bm}"] = got
        expect(got == at.tile_smem_bytes(bm, 128, kind="int8"),
               f"tile_smem_bytes int8 bm {bm}: kernel {got}")
    rec["smem_bytes_fp128"] = smem
    rec["serve_launch_us"] = graph_replay_us(torch)
    rec["hw_serve_launch_us"] = 1e6 * hw.SERVE_LAUNCH_S
    return rec


def stream_sizes(np) -> np.ndarray:
    """The request stream: log-uniform row counts 1-STREAM_MAX_ROWS from
    seed 0."""
    rng = np.random.default_rng(0)
    return np.floor(np.exp(rng.uniform(0.0, np.log(STREAM_MAX_ROWS + 1),
                                       STREAM_REQUESTS))).astype(np.int64)


def same_bits(torch, r, want) -> bool:
    """A ServeResult's labels and distances bit for bit ``want`` (assign,
    sq-dist) on the device."""
    am, md = want[0].cpu(), want[1].cpu()
    return bool(torch.equal(torch.from_numpy(r.labels), am)) and bool(
        torch.equal(torch.from_numpy(r.sq_dists).view(torch.int32),
                    md.view(torch.int32)))


def phase_serving(torch, np, ops, KMeans, x, c_init, km_off, km_ft,
                  wrappers) -> tuple[dict, dict]:
    """Phase 15 (c): ``to_service()`` of phase 3's fused model, phase 4's
    lloyd_ft model and a bf16 fused model, at ``SERVE_BUCKETS`` and at
    ``plan_ladder``'s ladder: one CUDA graph a bucket (captures = buckets),
    ``ops.row_norms`` independent of the row count, requests of
    ``SERVE_SIZES`` rows bitwise ``predict`` (labels and
    distances; det 0), no eager launch while serving (the wrappers'
    counters do not move); then a stream of ``STREAM_REQUESTS`` requests
    with three publishes (one from the ``on_dispatch`` hook mid-flight, whose
    batch keeps its version) and a refine, each answer bitwise the predict
    of its version's codebook, captures unchanged, and ``from_state(
    get_state())`` serving the same; readings: each bucket's replay and
    dispatch beside eager predict, requests/s of the started micro-batcher
    beside one predict a request, and the card's idle share over the
    stream. Launches: the cells' construction (warm-up + capture) counted by
    the wrappers plus each kernel's calls a cell times its replays."""
    from repro_torch.serve import DEFAULT_BUCKETS, KMeansService, plan_ladder
    expect(SERVE_BUCKETS == DEFAULT_BUCKETS, f"SERVE_BUCKETS {SERVE_BUCKETS}"
           f" are not the serving layer's DEFAULT_BUCKETS {DEFAULT_BUCKETS}")
    x_host = x.cpu().numpy()
    rng = np.random.default_rng(SEED)
    rec = {"phase": 15, "part": "c: serving",
           "row_norms": row_norm_invariance(torch, ops)}
    launches: dict = {}
    km_bf16 = KMeans(K_FULL, compute_dtype="bfloat16", max_iter=2, tol=0.0,
                     random_state=SEED).fit(x, centroids=c_init)
    models = {"fused": (km_off, ""), "lloyd_ft": (km_ft, ""),
              "fused_bf16": (km_bf16, "bf16")}
    requests = {m: x_host[rng.choice(M_FULL, m, replace=False)]
                for m in SERVE_SIZES}
    for name, (km, tag) in models.items():
        plan = plan_ladder(K_FULL, F_FULL, dtype=km.compute_dtype)
        r = {"predict_backend": km._predict_backend().name,
             "planned_buckets": list(plan.buckets),
             "planned_window_us": plan.window_us}
        for ladder_name, buckets in (("default", SERVE_BUCKETS),
                                     ("planned", plan.buckets)):
            for w in wrappers.values():
                w.launches = 0
            svc, build_s = wall(lambda: km.to_service(buckets=buckets))
            built = counts_of(wrappers)
            comp = svc.compiler
            expect(comp.captures == len(buckets),
                   f"{name}: {comp.captures} captures for {len(buckets)} "
                   f"buckets")
            per_call = {}
            for key, n in built.items():
                expect(n % (2 * len(buckets)) == 0,
                       f"{name}: {key} launched {n} times building "
                       f"{len(buckets)} cells")
                per_call[key] = n // (2 * len(buckets))
            bitwise = True
            for m, q in requests.items():
                before = counts_of(wrappers)
                got = svc.predict(q)
                expect(counts_of(wrappers) == before,
                       f"{name}: serving {m} rows launched a kernel "
                       f"eagerly")
                want = km._predict_full(torch.as_tensor(q, device=DEV))
                ok = same_bits(torch, got, want)
                expect(ok, f"{name} ({ladder_name} buckets): {m} rows "
                       f"not bit for bit predict")
                expect(int(got.detected) == 0 and got.version == 1,
                       f"{name}: {m} rows detected {got.detected}, version "
                       f"{got.version}")
                bitwise &= ok
            replays = dict(comp.replays)
            add_counts(launches, tag, built)
            add_counts(launches, tag, per_call, sum(replays.values()))
            r[ladder_name] = {"buckets": list(buckets),
                              "build_s": build_s,
                              "captures": comp.captures,
                              "replays": replays,
                              "kernels_a_replay": {k: v for k, v
                                                   in per_call.items() if v},
                              "bitwise_predict": bitwise}
            if ladder_name == "default":
                r["buckets_ms"] = bucket_times(torch, km, svc, x_host)
            del svc, comp
            torch.cuda.empty_cache()
        rec[name] = r
    rec["stream"], stream_counts = serve_stream(
        torch, np, KMeans, KMeansService, km_off, x_host, wrappers)
    add_counts(launches, "", stream_counts)
    return rec, launches


def row_norm_invariance(torch, ops) -> dict:
    """``ops.row_norms`` of a request's rows bit for bit those rows' norms
    in a larger X (the bucket a request is served in), at F 100, 128 and
    300 and 1-511 rows; beside it, how many row counts a plain
    ``(x ** 2).sum(1)`` of the prefix moves (the control)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    out = {}
    for f in (100, F_FULL, 300):
        xr = torch.randn(4096, f, generator=gen, device=DEV)
        full = ops.row_norms(xr)
        ms = (1, 2, 3, 7, 8, 15, 16, 17, 100, 127, 511)
        moved = [m for m in ms if not torch.equal(ops.row_norms(xr[:m]),
                                                  full[:m])]
        expect(not moved, f"ops.row_norms at F {f} moves with the row "
               f"count: {moved}")
        plain = (xr ** 2).sum(1)
        out[f"f{f}_plain_sum_moves_at"] = [
            m for m in ms if not torch.equal((xr[:m] ** 2).sum(1), plain[:m])]
    return out


def bucket_times(torch, km, svc, x_host) -> dict:
    """Each bucket's graph replay (device ms, CUDA events), its dispatch of
    a bucket-sized request (host ms, answer on the host) and eager
    ``predict`` of the same rows (host ms, answer on the host)."""
    out = {}
    for b, cell in svc.compiler._cells.items():
        q = x_host[:b]

        def dispatch():
            return [t.cpu() for t in svc.compiler.dispatch(
                q, km.cluster_centers_)]

        def eager():
            return [t.cpu() for t in km._predict_full(
                torch.as_tensor(q, device=DEV))]
        host = {}
        for what, fn in (("dispatch", dispatch), ("predict", eager)):
            fn()
            ts = []
            for _ in range(21):
                _, s = wall(fn)
                ts.append(1e3 * s)
            host[what] = sorted(ts)[10]
        out[str(b)] = {"replay_ms": cuda_ms(cell.graph.replay, reps=20),
                       "dispatch_host_ms": host["dispatch"],
                       "predict_host_ms": host["predict"]}
    return out


def serve_stream(torch, np, KMeans, KMeansService, km_off, x_host,
                 wrappers) -> tuple[dict, dict]:
    """The request stream through a fused f32 service at SERVE_BUCKETS:
    (1) one request at a time, publishes at requests 250 and 750, a publish
    from the ``on_dispatch`` hook while request 400's batch is in flight
    (that batch keeps its version, the next serves the new one), a refine
    at 500; every answer bit for bit the predict of its version's
    codebook; captures unchanged; the state's round trip serving the same;
    (2) readings: requests/s one at a time, with the window loop started
    (the planned window, and none) and STREAM_THREADS submitting threads,
    and one eager predict a request;
    the card's idle share over the first 200 requests of each. Returns the
    record and the launches of (1): the cells' construction, their
    replays and the refine's step."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serve import plan_ladder
    window_s = 1e-6 * plan_ladder(K_FULL, F_FULL).window_us
    sizes = stream_sizes(np)
    offs = np.random.default_rng(1).integers(0, M_FULL - STREAM_MAX_ROWS,
                                             STREAM_REQUESTS)
    reqs = [x_host[o:o + s] for o, s in zip(offs, sizes)]
    km = KMeans.from_state(km_off.get_state())        # refine moves it
    chk = KMeans.from_state(km_off.get_state())
    armed = {"on": False, "pinned": None}
    svc = None

    def hook(cb):
        if armed["on"]:
            armed["on"] = False
            armed["pinned"] = cb.version
            svc.publish(cb.centroids * 1.0001)
    for w in wrappers.values():
        w.launches = 0
    svc = KMeansService.from_estimator(km, buckets=SERVE_BUCKETS,
                                       on_dispatch=hook)
    counts = counts_of(wrappers)
    per_call = {k: n // (2 * len(SERVE_BUCKETS)) for k, n in counts.items()}
    rec = {"requests": STREAM_REQUESTS, "rows": int(sizes.sum()),
           "sizes_min_median_max": [int(sizes.min()), int(np.median(sizes)),
                                    int(sizes.max())]}
    versions, bitwise = [], True
    for i, q in enumerate(reqs):
        if i in (250, 750):
            svc.publish(svc.store.current().centroids * 0.9999)
        elif i == 500:
            before = counts_of(wrappers)
            svc.refine(x_host[:65_536])
            add_counts(counts, "", {k: n - before[k] for k, n
                                    in counts_of(wrappers).items()})
        armed["on"] = i == 400
        before = counts_of(wrappers)
        got = svc.predict(q)
        expect(counts_of(wrappers) == before,
               f"stream request {i} launched a kernel eagerly")
        versions.append(got.version)
        chk.cluster_centers_ = svc.store.get(got.version).centroids
        ok = same_bits(torch, got, chk._predict_full(
            torch.as_tensor(q, device=DEV)))
        bitwise &= ok
        expect(ok, f"stream request {i} ({len(q)} rows, version "
               f"{got.version}) not bit for bit predict on that codebook")
    replays = sum(svc.compiler.replays.values())
    add_counts(counts, "", per_call, replays)
    expect(armed["pinned"] == versions[400] and versions[401] ==
           versions[400] + 1, f"the batch hot-swapped mid-flight did not "
           f"keep its version: pinned {armed['pinned']}, served "
           f"{versions[400]}, next {versions[401]}")
    expect(versions == sorted(versions) and versions[-1] == 5,
           f"stream versions {sorted(set(versions))}")
    expect(svc.compiler.captures == len(SERVE_BUCKETS),
           f"captures moved to {svc.compiler.captures} over the stream")
    rec.update({"bitwise_predict_of_version": bitwise,
                "versions": sorted(set(versions)),
                "hot_swap_pinned": armed["pinned"],
                "captures": svc.compiler.captures,
                "replays": dict(svc.compiler.replays)})
    again = KMeansService.from_state(svc.get_state())
    rt = True
    for q in reqs[:50]:
        a, b = again.predict(q), svc.predict(q)
        rt &= bool(np.array_equal(a.labels, b.labels)) and bool(
            np.array_equal(a.sq_dists.view(np.int32),
                           b.sq_dists.view(np.int32))) \
            and a.version == b.version
    expect(rt, "from_state(get_state()) does not serve bit for bit")
    rec["state_round_trip_bitwise"] = rt
    rec["state_round_trip_captures"] = again.compiler.captures
    del again
    # readings
    _, one_s = wall(lambda: [svc.predict(q) for q in reqs])

    def eager_all():
        for q in reqs:
            am, md, _ = km._predict_full(torch.as_tensor(q, device=DEV))
            am.cpu(), md.cpu()
    _, eager_s = wall(eager_all)
    pool_s = {}
    for window in (window_s, 0.0):
        svc.batcher.window_s = window
        svc.start()
        with ThreadPoolExecutor(STREAM_THREADS) as pool:
            _, pool_s[window] = wall(lambda: list(pool.map(svc.predict,
                                                           reqs)))
        svc.stop()
    rec["requests_per_s"] = {
        "service_one_at_a_time": STREAM_REQUESTS / one_s,
        "service_started_threads": STREAM_REQUESTS / pool_s[window_s],
        "service_started_threads_no_window": STREAM_REQUESTS / pool_s[0.0],
        "eager_predict_each": STREAM_REQUESTS / eager_s,
        "threads": STREAM_THREADS, "window_us": 1e6 * window_s}
    rec["trace_service"] = device_trace(
        torch, lambda: [svc.predict(q) for q in reqs[:200]])
    rec["trace_eager_predict"] = device_trace(
        torch, lambda: [[t.cpu() for t in km._predict_full(
            torch.as_tensor(q, device=DEV))[:2]] for q in reqs[:200]])
    return rec, counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import hw
    from repro_torch.api import FaultPolicy, InjectionCampaign, KMeans
    from repro_torch.batch import BatchedKMeans
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import distance_argmin_ft as daft
    from repro_torch.kernels import distance_argmin_int8 as dai
    from repro_torch.kernels import kmeanspp_init as kpp
    from repro_torch.kernels import lloyd_step as ll
    from repro_torch.kernels import lloyd_step_ft as llft
    from repro_torch.kernels import lloyd_step_pruned as llp
    from repro_torch.kernels import centroid_update_dmr as cud
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul_abft as mma
    from repro_torch.kernels import update as up
    from repro_torch.models import attention as attn

    ref.full_f32(torch.device("cuda"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = _build.build_all()          # one nvcc per source, in parallel
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs.values()
             for ln in lib.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry function" in ln or "C75" in ln]
    f32_tiles = f32_tile_resources(da, libs["fk_kernels"].ptxas_log)
    redesigned = redesigned_resources(da, dai, libs["fk_kernels"].ptxas_log)
    redesigned.update(attention_dmr_resources(cud, fa, libs))
    emit({"phase": 1, "device": kind, "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3),
          "nvcc_s": {name: round(lib.build_seconds, 3)
                     for name, lib in libs.items()},
          "f32_tile_kernel": f32_tiles, **redesigned, "ptxas": ptxas})
    for name, r in redesigned["flash_f32_kernel"].items():
        expect(r["blocks_per_sm"] >= 1, f"flash_f32_kernel {name}: {r}")
    for name, r in f32_tiles.items():
        expect(not name.startswith("bm128") or r["blocks_per_sm"] >= 2,
               f"f32 lloyd_tile_kernel {name}: {r['blocks_per_sm']} block(s) "
               f"an SM")
    for name, r in redesigned["lloyd_tile_mma_kernel"].items():
        expect(all(v["blocks_per_sm"] >= 2 for key, v in r.items()
                   if key.startswith("fp")),
               f"lloyd_tile_mma_kernel {name}: {r} (two blocks an SM)")

    kern = (da, ll, daft, llft)
    emit(phase_kernels(torch, ops, kern))

    # --- phase 3: unprotected fit at full size ------------------------------
    x_np, labels_np = make_blobs(M_FULL, F_FULL, K_FULL, seed=SEED)
    x = torch.from_numpy(x_np).cuda()
    labels_true = torch.from_numpy(labels_np).cuda()
    del x_np, labels_np
    wrappers = {"distance_argmin": da.distance_argmin,
                "lloyd_step": ll.lloyd_step,
                "distance_argmin_ft": daft.distance_argmin_ft,
                "lloyd_step_ft": llft.lloyd_step_ft,
                "verify_entries": llft.verify_entries,
                "update_entries": up.update_entries,
                "tree_reduce": up.tree_reduce,
                "prep_centroids": da.prep_centroids}
    for w in wrappers.values():
        w.launches = 0
    up.tree_reduce.kernel_launches.update(sparse=0, dense=0)
    base = dict(n_clusters=K_FULL, max_iter=ITERS, tol=0.0, random_state=SEED)
    km_seed, seed_s = wall(lambda: KMeans(fault=FaultPolicy.off(),
                                          **base).fit(x))
    c_init = km_seed.init_centroids(x)
    km_off, off_s = wall(lambda: KMeans(fault=FaultPolicy.off(), **base)
                         .fit(x, centroids=c_init))
    labels = km_off.predict(x)
    score = km_off.score(x)
    km_ll, ll_s = wall(lambda: KMeans(fault=FaultPolicy.off(),
                                      backend="lloyd", **base)
                       .fit(x, centroids=c_init))
    # both update in emit_update's order, so they agree bit for bit
    expect(bool(torch.equal(km_ll.labels_, km_off.labels_)),
           "lloyd fit labels differ from the fused fit")
    c_err = max_err(km_ll.cluster_centers_, km_off.cluster_centers_)
    expect(c_err == 0.0, f"lloyd fit centroids differ from the fused fit "
           f"({c_err})")
    expect(bool(torch.isfinite(km_off.cluster_centers_).all())
           and km_off.cluster_centers_.shape == (K_FULL, F_FULL),
           "fit centroids not finite or of the wrong shape")
    expect(labels.shape == (M_FULL,) and int(labels.min()) >= 0
           and int(labels.max()) < K_FULL, "predict labels out of range")
    expect(np.isfinite(score) and score < 0, f"score {score}")
    emit({"phase": 3, "m": M_FULL, "f": F_FULL, "k": K_FULL,
          "seeded_fit_s": round(seed_s, 4), "n_iter": km_off.n_iter_,
          "fused_ms_per_iter": 1e3 * off_s / km_off.n_iter_,
          "lloyd_ms_per_iter": 1e3 * ll_s / km_ll.n_iter_,
          "inertia": km_off.inertia_, "score": score,
          "lloyd_centroid_err": c_err, "n_host_syncs": km_off._n_host_syncs})

    # --- phase 4: protected fit, clean and under a campaign ------------------
    km_ft, ft_s = wall(lambda: KMeans(fault=FaultPolicy.correct(), **base)
                       .fit(x, centroids=c_init))
    expect(km_ft.detected_errors_ == 0,
           f"clean protected fit detected {km_ft.detected_errors_}")
    expect(bool(torch.equal(km_ft.cluster_centers_, km_ll.cluster_centers_)),
           "clean protected fit is not bit for bit the lloyd fit")
    camp = FaultPolicy.correct(injection=InjectionCampaign(rate=1.0,
                                                           targets="both"))
    km_camp, camp_s = wall(lambda: KMeans(fault=camp, **base)
                           .fit(x, centroids=c_init))
    expect(km_camp.detected_errors_ > 0, "campaign detected nothing")
    expect(bool(torch.equal(km_camp.cluster_centers_, km_ft.cluster_centers_)),
           "campaign centroids are not bitwise the clean protected fit's")
    ft_labels = km_ft.predict(x)
    ft_score = km_ft.score(x)
    expect(bool(torch.equal(ft_labels, km_ll.predict(x))),
           "protected predict differs from unprotected predict")
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    # the tree_reduce row is the variant over entries, the one these fits run
    tree_kinds = dict(up.tree_reduce.kernel_launches)
    launches["tree_reduce"] = tree_kinds["sparse"]
    off_ms = 1e3 * off_s / km_off.n_iter_
    ft_ms = 1e3 * ft_s / km_ft.n_iter_
    emit({"phase": 4, "clean_detected": km_ft.detected_errors_,
          "campaign_detected": km_camp.detected_errors_,
          "ft_ms_per_iter": ft_ms, "campaign_ms_per_iter":
          1e3 * camp_s / km_camp.n_iter_, "ft_overhead_vs_fused":
          ft_ms / off_ms, "ft_overhead_vs_lloyd":
          ft_ms / (1e3 * ll_s / km_ll.n_iter_), "score": ft_score,
          "n_host_syncs": km_ft._n_host_syncs,
          "tree_reduce_variants": tree_kinds})
    for name, n in launches.items():
        expect(n > 0, f"{name} was not launched on the main path")

    # --- phase 5: per-kernel times at the phase-3 shape ----------------------
    params = ops.clamp_params(M_FULL, K_FULL, F_FULL, ops.DEFAULT_PARAMS)
    plan = ops.plan_data(x, params)
    # blob centres as centroids: the main path's shapes, with margins wide
    # enough that kernel and plain version must agree on every label
    c = torch.from_numpy(blob_centers(K_FULL, F_FULL, SEED)).cuda()
    kp = -(-K_FULL // params.block_k) * params.block_k
    cp, cn = ops._pad_centroids(c, K_FULL, kp, plan.xp.shape[1])
    mp, fp = plan.xp.shape
    nt = mp // params.block_m
    tiles = dict(block_m=params.block_m, block_k=params.block_k,
                 block_f=params.block_f)
    factor = ops.threshold_factor(fp, torch.float32)
    no_d, no_l = daft.no_injection().cuda(), llft.no_injection().cuda()
    # a bound counts the function's work at the true M, K and F; the
    # figures at the padded grid (Kp = 1024) are printed beside it
    gemm = 2.0 * M_FULL * K_FULL * F_FULL
    x_bytes, c_bytes = 4.0 * M_FULL * F_FULL, 4.0 * K_FULL * F_FULL
    part_bytes = 4.0 * nt * K_FULL * F_FULL + 4.0 * nt * K_FULL
    assign_out = 8.0 * M_FULL
    padded_gemm = 2.0 * mp * kp * fp
    n_present = int((ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)[4]
                     >= 0).sum())
    ent_bytes = entry_bytes(n_present, F_FULL, K_FULL, nt)

    def library_call():
        d = torch.addmm(cn[None, :], plan.xp, cp.T, beta=1.0, alpha=-2.0)
        return d.min(dim=1)
    lib_ms = cuda_ms(library_call)

    def bound(ops_n: float, bytes_n: float,
              peak: float = hw.PEAK_FLOPS_F32) -> tuple[float, str]:
        t_ops = ops_n / peak
        t_bytes = bytes_n / hw.HBM_BW
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    rows, padded_bounds = [], {}
    specs = [
        ("distance_argmin", "src/repro/kernels/distance_argmin.py:140",
         lambda: da.distance_argmin(plan.xp, cp, cn, **tiles),
         lambda: da.distance_argmin_plain(plan.xp, cp, cn),
         gemm, x_bytes + c_bytes + assign_out),
        ("lloyd_step", "src/repro/kernels/lloyd_step.py:345",
         lambda: ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles),
         lambda: ll.lloyd_step_plain(plan.xp, cp, cn, plan.m,
                                     params.block_m),
         gemm + M_FULL * F_FULL,
         x_bytes + c_bytes + assign_out + ent_bytes),
        ("distance_argmin_ft", "src/repro/kernels/distance_argmin_ft.py:207",
         lambda: daft.distance_argmin_ft(plan.xp, cp, cn, no_d,
                                         factor=factor, **tiles),
         lambda: daft.distance_argmin_ft_plain(plan.xp, cp, cn, no_d,
                                               params.block_m,
                                               params.block_k,
                                               params.block_f, factor),
         gemm, x_bytes + c_bytes + assign_out + 4.0 * nt),
        ("lloyd_step_ft", "src/repro/kernels/lloyd_step_ft.py:292",
         lambda: llft.lloyd_step_ft(plan.xp, cp, cn, no_l, plan.m,
                                    factor=factor, **tiles),
         lambda: llft.lloyd_step_ft_plain(plan.xp, cp, cn, no_l, plan.m,
                                          params.block_m, params.block_k,
                                          params.block_f, factor),
         gemm + 3.0 * M_FULL * F_FULL, x_bytes + c_bytes + assign_out
         + ent_bytes + 4.0 * M_FULL + 4.0 * nt * (2 * F_FULL + 3)),
    ]
    for name, replaces, kfn, pfn, ops_n, bytes_n in specs:
        k_out = canon(up, name, kfn(), params.block_m)
        p_out = canon(up, name, pfn(), params.block_m)
        pairs = [(a, b) for a, b in zip(k_out, p_out) if a.is_floating_point()]
        err = max(max_err(a, b) for a, b in pairs)
        expect(all(rel_ok(a, b, 1e-5)[0] for a, b in pairs),
               f"{name} disagrees with its plain version beyond rtol 1e-5")
        expect(bool(torch.equal(k_out[1], p_out[1])),
               f"{name} labels differ from its plain version")
        del k_out, p_out, pairs
        torch.cuda.empty_cache()
        b_ms, b_by = bound(ops_n, bytes_n)
        padded_bounds[name] = bound(ops_n - gemm + padded_gemm, bytes_n)[0]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/fk_kernels.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err,
                     "ms": cuda_ms(kfn), "plain_ms": cuda_ms(pfn, reps=2),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
        torch.cuda.empty_cache()
    f32_share = {r["name"]: r["bound_ms"] / r["ms"] for r in rows}
    # the witness that lloyd_step's FMA chains and min/argmin did not move:
    # for 8 row tiles spread over X (1024 rows) against every centroid, each
    # distance's FMAs chained over the features in order on the card, each
    # an f32 FMA emulated in f64 (distance_argmin.fma_f32), then cn - 2 acc
    # and the first minimum: lloyd_step's minima and labels bit for bit
    st = ll.lloyd_step(plan.xp, cp, cn, plan.m, **tiles)
    sample = torch.linspace(0, nt - 1, 8, device="cuda").round().long()
    wrows = (sample[:, None] * params.block_m + torch.arange(
        params.block_m, device="cuda")[None, :]).reshape(-1)
    xw = plan.xp[wrows]
    acc = torch.zeros((xw.shape[0], kp), dtype=torch.float32, device="cuda")
    for f in range(fp):
        acc = da.fma_f32(xw[:, f, None], cp[None, :, f], acc)
    w_min, w_arg = ref.first_min(cn[None, :] - 2.0 * acc)
    fma_witness = {"rows": int(wrows.numel()), "bitwise": bool(
        torch.equal(w_arg, st[1][wrows])) and bool(torch.equal(
            w_min.view(torch.int32), st[0][wrows].view(torch.int32)))}
    expect(fma_witness["bitwise"], "lloyd_step's minima / labels are not "
           "bit for bit the features' FMA chains (fma_f32) and their first "
           "minimum (phase-3 shape)")
    del st, xw, acc, w_min, w_arg
    torch.cuda.empty_cache()
    # the f32 tile kernels' pre-pass: C feature-major, C's encodings (FT)
    got = da.prep_centroids(cp, encodings=True)
    want = da.prep_centroids_plain(cp, encodings=True)
    expect(bool(torch.equal(got[0], want[0])) and bool(torch.equal(
        got[1].view(torch.int32), want[1].view(torch.int32))),
        "prep_centroids is not bit for bit its plain version")
    nkt = kp // params.block_k
    b_ms, b_by = bound(2.0 * K_FULL * F_FULL, 2.0 * c_bytes
                       + 8.0 * nkt * F_FULL)
    rows.append({"name": "prep_centroids", "route": "cuda",
                 "source": "src/repro_torch/csrc/fk_kernels.cu",
                 "replaces": "src/repro/kernels/distance_argmin.py:140 and "
                             "distance_argmin_ft.py:207 (C staged "
                             "feature-major for the f32 tile kernels and "
                             "its checksum encodings; the port's own "
                             "pre-pass)",
                 "launches": launches["prep_centroids"], "max_abs_err": 0.0,
                 "ms": cuda_ms(lambda: da.prep_centroids(cp, True), reps=20),
                 "plain_ms": cuda_ms(lambda: da.prep_centroids_plain(
                     cp, True), reps=2),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": cuda_ms(lambda: cp.t().contiguous(),
                                       reps=20)})
    del got, want
    # the dense update alone (emit_update over every row tile: the parent's
    # two-pass route, the reference every route is held to): bit for bit
    # the dense one-pass kernel's (the batched launch of one problem)
    bm = params.block_m
    am = da.distance_argmin(plan.xp, cp, cn, **tiles)[1]
    want_s, want_c = (t[0] for t in ll.lloyd_step_batched(
        plan.xp[None], cp[None], cn[None], plan.m, **tiles)[2:])
    sums_p, counts_p = torch.empty_like(want_s), torch.empty_like(want_c)

    def update():
        ll.tile_update(plan.xp, am, sums_p, counts_p, true_m=plan.m,
                       block_m=bm)
        return sums_p, counts_p
    update()
    expect(bool(torch.equal(sums_p, want_s))
           and bool(torch.equal(counts_p, want_c)),
           "tile_update is not bit for bit the dense one-pass update")
    mid = nt // 2
    sums_p[mid] = 0.0
    ll.tile_update(plan.xp, am, sums_p, counts_p, true_m=plan.m, block_m=bm,
                   tile=torch.tensor(mid, dtype=torch.int32, device="cuda"),
                   gate=torch.tensor(1, dtype=torch.int32, device="cuda"))
    expect(bool(torch.equal(sums_p, want_s)),
           "tile_update of one tile is not bit for bit the kernel's tile")
    del want_s, want_c
    torch.cuda.empty_cache()
    valid = (torch.arange(mp, device="cuda") < plan.m).view(nt, bm)

    def update_plain():
        return ll.tile_update_plain(plan.xp.view(nt, bm, fp), am.view(nt, bm),
                                    valid, kp)
    p_s, p_c = update_plain()
    ok, upd_err = rel_ok(sums_p, p_s, 1e-5)
    expect(ok and bool(torch.equal(counts_p, p_c)),
           "tile_update disagrees with its plain version")
    del p_s, p_c
    torch.cuda.empty_cache()
    am_long = am.long()
    dense_ms = cuda_ms(update)
    # the compact update (A: the per-tile pass, then the tree over its
    # entries) and the tree kernel on the dense partials (B), each bit for
    # bit the parent's route: these partials, then the torch tree
    rec_a, rows_a = compact_update_rows(torch, up, plan, am, kp, bm,
                                        sums_p, counts_p, x_bytes, bound,
                                        launches, "")
    rec5 = {"phase": 5, **rec_a, "f32_bound_share": f32_share,
            "lloyd_step_fma_witness": fma_witness,
            "library_calls": {"prep_centroids": "c.t().contiguous(): the "
                              "transpose alone, no encodings"}}
    rows.extend(rows_a)
    lloyd_tree = (up.tree_sum_plain(sums_p), up.tree_sum_plain(counts_p))

    def tree():
        return up.tree_sum(sums_p), up.tree_sum(counts_p)
    expect(all(bool(torch.equal(a, b)) for a, b in zip(tree(), lloyd_tree)),
           "the tree kernel on lloyd_step's partials is not bit for bit the "
           "torch tree")
    del lloyd_tree
    # the dense variant at lloyd_step-sized partials (the pruned fit's
    # shape; the one-pass fits reduce entries: the tree_reduce row)
    dense_tree = {
        "ms": cuda_ms(tree),
        "torch_tree_ms": cuda_ms(lambda: (up.tree_sum_plain(sums_p),
                                          up.tree_sum_plain(counts_p)),
                                 reps=2),
        "bound_ms": bound(nt * K_FULL * F_FULL, part_bytes
                          + 4.0 * (K_FULL * F_FULL + K_FULL))[0],
        "sum0_ms": cuda_ms(lambda: (sums_p.sum(0), counts_p.sum(0)))}
    del sums_p, counts_p
    torch.cuda.empty_cache()
    # the two-pass update as the fused fit runs it, and under DMR (a
    # replica, a compare, a recompute gated off); peak memory of each
    am_m = am[:plan.m]

    rec_o, rows_o = onepass_rows(torch, ops, up, llft, plan, c, params,
                                 bound, "", launches)
    rec5.update(rec_o)
    rows.extend(rows_o)
    rec5["dense_tile_update_ms"] = dense_ms
    rec5.update({
        "gemm_bound_padded_ms": padded_bounds,
        "tiled_update_peak_gb": peak_gb(
            lambda: ops.tiled_update(plan, am_m, K_FULL)),
        "tiled_update_dmr_peak_gb": peak_gb(
            lambda: ops.tiled_update(plan, am_m, K_FULL, use_dmr=True)),
        "tiled_update_ms": cuda_ms(
            lambda: ops.tiled_update(plan, am_m, K_FULL), reps=3),
        "tiled_update_dmr_ms": cuda_ms(
            lambda: ops.tiled_update(plan, am_m, K_FULL, use_dmr=True),
            reps=3),
        "dense_partials_tree": dense_tree})
    rec5["tiled_update_over_index_add"] = (rec5["tiled_update_ms"]
                                           / rec5["index_add_ms"])
    emit(rec5)
    del plan, am, am_m, am_long, valid
    torch.cuda.empty_cache()

    # --- phases 6-7: the batched path at the PQ shape -----------------------
    emit(phase_batched_kernels(torch, ops, hw, ll, kpp))
    rec7, rows7 = phase_batched_fit(torch, ops, hw, ll, kpp, bound, KMeans,
                                    BatchedKMeans)
    emit(rec7)
    rows.extend(rows7)

    # --- phases 8-9: the pruned and int8 paths --------------------------------
    emit(phase_pruned_int8_kernels(torch, ops, ll, llp, dai))
    rec9, rows9 = phase_pruned_int8_fits(torch, ops, hw, llp, dai, KMeans, x,
                                         labels_true, c_init, km_ll, km_off,
                                         lib_ms, bound)
    emit(rec9)
    rows.extend(rows9)
    dense_row = next(r for r in rows if r["name"] == "tree_reduce_dense")
    dense_row["launches"] += rec9["tree_reduce_variants"]["dense"]

    # --- phase 10: detect (offline ABFT), the ABFT GEMM, the DMR update ----
    rec10, rows10 = phase_detect(torch, ops, hw, ll, mma, cud, KMeans,
                                 FaultPolicy, InjectionCampaign, x, c_init,
                                 km_off, km_ft, off_ms, ft_ms, bound)
    emit(rec10)
    rows.extend(rows10)

    # --- phases 11-12: the flash kernel, internlm2-1.8b serving -------------
    rec11, rows11 = phase_flash(torch, fa, hw)
    emit(rec11)
    rec12 = phase_lm_serve(torch, fa, KMeans, FaultPolicy, InjectionCampaign)
    emit(rec12)
    by_kernel = rec12["flash_launches_by_kernel"]
    rows.append(dict(rows11[0], launches=by_kernel["flash_prefill_kernel"]))
    rows.append(dict(rows11[1], launches=by_kernel["flash_decode_kernel"]))

    # --- phase 13: the bf16 / fp16 compute dtypes ---------------------------
    rec13, rows13 = phase_lowp(
        torch, ops, hw, kern, KMeans, FaultPolicy, InjectionCampaign, x,
        c_init, km_off, {"fused": off_ms, "lloyd": 1e3 * ll_s / km_ll.n_iter_,
                         "lloyd_ft": ft_ms}, bound)
    emit(rec13)
    rows.extend(rows13)

    # --- phase 14: the rest of the 2-byte variants --------------------------
    rec14, rows14 = phase_lowp_rest(
        torch, ops, hw, ll, llp, mma, fa, attn, KMeans, BatchedKMeans,
        FaultPolicy, x, labels_true, c_init, bound)
    emit(rec14)
    rows.extend(rows14)

    # --- phase 15: mini-batch fits, autotune, k-means serving ---------------
    wrappers15 = dict(wrappers, distance_argmin_int8=dai.distance_argmin_int8,
                      encode_centroids=daft.encode_centroids)
    rec15a, launches15 = phase_minibatch(torch, np, ops, KMeans, FaultPolicy,
                                         InjectionCampaign, x, c_init,
                                         wrappers15)
    emit(rec15a)
    emit(phase_autotune(torch, ops, hw, da, dai))
    rec15c, launches_c = phase_serving(torch, np, ops, KMeans, x, c_init,
                                       km_off, km_ft, wrappers15)
    emit(rec15c)
    add_counts(launches15, "", launches_c)
    for name in ("distance_argmin", "distance_argmin_bf16",
                 "distance_argmin_ft", "lloyd_step", "lloyd_step_ft",
                 "lloyd_step_bf16", "distance_argmin_int8", "prep_centroids"):
        expect(launches15.get(name, 0) > 0,
               f"{name} was not launched on phase 15's paths")
    by_name = {r["name"]: r for r in rows}
    added = {name: n for name, n in launches15.items() if name in by_name}
    for name, n in added.items():
        by_name[name]["launches"] += n
    emit({"phase": 15, "part": "launches added to the kernels line",
          "launches": added})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
