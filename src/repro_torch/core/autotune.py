"""Tile selection for the port's CUDA kernels (counterpart of
``repro.core.autotune``), re-derived for the H100.

The reference generates kernels over a tile space, keeps the ones that fit
and run, scores each candidate per problem shape and persists the winners
(paper §III-B). The port keeps that pipeline over the tiles its CUDA
templates are built for:

  1. :func:`parameter_space` -- ``hw.SUPPORTED_BLOCK_M`` x
     ``hw.SUPPORTED_BLOCK_K`` at ``block_f = hw.FEATURE_CHUNK`` (a wider
     ``block_f`` only pads F further: it moves the injection unit, not the
     kernels' loop); the ``init`` kind has the one row tile
     ``hw.INIT_BLOCK_N`` (the k-means++ round's two-level selection walks
     that tile on both devices, so another tile would draw other seeds).
  2. :func:`feasible` -- the alignments of ``ops.clamp_params``, a built
     tile, and each instantiation's dynamic shared memory
     (:func:`tile_smem_bytes`, the kernels' own layouts) under
     ``hw.SMEM_PER_BLOCK``.
  3. :func:`model_score` -- a roofline over the H100 (``repro_torch.hw``),
     or :func:`measure_score` -- CUDA-event time of the real kernel.
  4. ``repro_torch.api.cache.AutotuneCache`` persists the winners.

Candidates are ordered from the largest row tile down, and a later one
wins only when it scores strictly lower, so ties keep the larger tile.
Every kernel of the port has one template per (kind, dtype) whatever K is,
so the variant of a winner is ``"generic"`` (``"batched"`` for the batched
kind), kept in the table for the reference's entry format.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Iterable, Optional

import torch

from repro_torch import hw
from repro_torch.kernels.ops import (PLAN_KINDS, KernelParams, _round_up,
                                     clamp_params)

KINDS = PLAN_KINDS
_LLOYD_KINDS = ("lloyd", "lloyd_ft", "pruned")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def as_dtype(dtype: Any) -> torch.dtype:
    """A dtype spec (None, a name, a torch dtype or a numpy dtype) as the
    torch dtype of a kind's compute: float32 (the default), bfloat16,
    float16 or int8."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"compute dtype must be one of {sorted(_DTYPES)}, "
                         f"got {dtype!r}")
    return _DTYPES[name]


def shard_shape(m: int, k: int, f: int,
                data_shards: int) -> tuple[int, int, int]:
    """The per-shard problem shape a data-sharded fit tunes for: tiles see
    the local (rows / shard, K, F) problem. Rows must divide evenly."""
    if data_shards < 1:
        raise ValueError(f"data_shards must be >= 1, got {data_shards}")
    if m % data_shards:
        raise ValueError(
            f"rows m={m} do not divide evenly over {data_shards} data "
            f"shards; pad the input or pick a mesh whose row parallelism "
            f"divides M")
    return (m // data_shards, k, f)


def parameter_space(dtype: Any = torch.float32,
                    kind: str = "assign") -> list[KernelParams]:
    """Candidate tiles of one kind: the built ones, largest row tile first.
    The dtype does not widen the space: every template is built for the
    same row and centroid tiles at every dtype."""
    as_dtype(dtype)
    if kind == "init":
        return [KernelParams(hw.INIT_BLOCK_N, hw.BLOCK_K, hw.BLOCK_F)]
    return [KernelParams(bm, bk, hw.FEATURE_CHUNK)
            for bm in sorted(hw.SUPPORTED_BLOCK_M, reverse=True)
            for bk in sorted(hw.SUPPORTED_BLOCK_K, reverse=True)]


# --- the kernels' shared-memory layouts (csrc/fk_kernels.cu) ---------------

_BK, _CHUNK = 128, 32                               # kBK, kChunk
_MMA_STAGES, _MMA_STASH, _MMA_PAD, _MMA_WIDE = 3, 48 * 1024, 8, 64
_TWO_BLOCKS = 113 * 1024                            # kTwoBlockBytes
_I8_PITCH, _I8_STAGES, _I8_STASH = 128 + 16, 3, 48 * 1024


def _f32_bytes(bm: int, fp: int, ft: bool, ntiles: int) -> int:
    """``F32Layout<BM>::bytes``: a two-slot ring of X's and C's 32-feature
    chunks (rows padded by 4 words), cn, C's encodings, the checksum
    vectors and the verdict; at kFT X's encodings and half of Ds; pruned,
    the list of centroid tiles."""
    slot = _CHUNK * (bm + 4) + _CHUNK * (_BK + 4)
    xenc = 2 * slot + 2 * _BK + 4 * _CHUNK + 4 * _BK + 4 * bm + 4
    return 4 * (xenc + (2 * fp + bm // 2 * (_BK + 1) if ft else 0)
                + (16 + bm + ntiles + 1 if ntiles else 0))


def _mma_bytes(bm: int, fp: int, ft: bool, ntiles: int) -> int:
    """``MmaLayout(bm, fp, ft, ntiles).bytes`` of the 2-byte kernels: X's
    row tile kept when it fits 48 KB and leaves two blocks an SM, else
    streamed with C through the three-slot ring."""
    def place(stash: bool) -> int:
        ck = _MMA_WIDE if stash and not ft and fp >= _MMA_WIDE else _CHUNK
        cpitch = ck + _MMA_PAD
        un = bm * (fp + _MMA_PAD) * 2 if stash else 0
        slot = (_BK + (8 if ft else 0) + (0 if stash else bm)) * cpitch * 2
        body = _MMA_STAGES * slot
        if ft:
            body = max(body, bm * (_BK + 1) * 4)
        end = un + -(-body // 16) * 16 + _MMA_STAGES * _BK * 4
        end += 4 * (_BK + bm) * 4 + 2 * (_BK + 8 * _CHUNK) * 4 + 16 \
            + 2 * fp * 4 if ft else 4 * bm * 8
        return end + ((16 + bm + ntiles + 1) * 4 if ntiles else 0)
    stash = bm * (fp + _MMA_PAD) * 2 <= _MMA_STASH
    got = place(stash)
    return place(False) if stash and got > _TWO_BLOCKS else got


def _int8_bytes(bm: int, fp: int) -> int:
    """``Int8Layout(bm, fp).bytes``: X's quantised row tile kept when it
    fits 48 KB, a three-slot ring of C's 128-feature chunks (and X's when
    streamed), sc / cn pairs, sx and the row bands' pairs."""
    stash = bm * (fp + 16) <= _I8_STASH
    slot = (_BK + (0 if stash else bm)) * _I8_PITCH
    ring = bm * (fp + 16) if stash else 0
    return ring + _I8_STAGES * slot + _I8_STAGES * 2 * _BK * 4 + bm * 4 \
        + 4 * bm * 8


def tile_smem_bytes(block_m: int, fp: int, *, kind: str = "assign",
                    kp: int = _BK, dtype: Any = torch.float32) -> int:
    """Dynamic shared memory of the tile kernel a kind launches at row tile
    ``block_m``, padded features ``fp`` and padded centroids ``kp``: the f32
    ``lloyd_tile_kernel``, the 2-byte ``lloyd_tile_mma_kernel`` (FT for
    ``lloyd_ft``, pruned for ``pruned``) or ``int8_tile_kernel``. On the
    card ``distance_argmin.tile_resources`` reports the same bytes."""
    if kind == "int8" or as_dtype(dtype) == torch.int8:
        return _int8_bytes(block_m, fp)
    ft = kind == "lloyd_ft"
    ntiles = kp // _BK if kind == "pruned" else 0
    if as_dtype(dtype) == torch.float32:
        return _f32_bytes(block_m, fp, ft, ntiles)
    return _mma_bytes(block_m, fp, ft, ntiles)


def feasible(p: KernelParams, dtype: Any = torch.float32, *,
             kind: str = "assign",
             shape: Optional[tuple[int, int, int]] = None,
             variant: str = "generic") -> bool:
    """A built tile, aligned as ``ops.clamp_params`` keeps it, whose
    instantiation's shared memory fits ``hw.SMEM_PER_BLOCK`` at the padded
    shape (at F = ``block_f`` and one centroid tile without a shape). The
    ``init`` kind needs a row tile that is a multiple of 128 (the round's
    selection tiles); its kernel's shared memory is static."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "init":
        return p.block_m >= 128 and p.block_m % 128 == 0
    if (p.block_m % hw.ALIGN_M or p.block_k % hw.ALIGN_K
            or p.block_f % hw.ALIGN_F
            or p.block_m not in hw.SUPPORTED_BLOCK_M
            or p.block_k not in hw.SUPPORTED_BLOCK_K
            or p.block_f % hw.FEATURE_CHUNK):
        return False
    _, k, f = shape if shape is not None else (0, p.block_k, p.block_f)
    fp, kp = _round_up(f, p.block_f), _round_up(k, p.block_k)
    if kind == "int8" and fp > 0x7fffffff // (128 * 128):
        return False                   # the int32 accumulator's Fp limit
    smem = tile_smem_bytes(p.block_m, fp, kind=kind, kp=kp,
                           dtype=torch.int8 if kind == "int8" else dtype)
    return smem <= hw.SMEM_PER_BLOCK


def _peak(dtype: torch.dtype) -> float:
    if dtype == torch.int8:
        return hw.PEAK_OPS_INT8
    if dtype == torch.float32:
        return hw.PEAK_FLOPS_F32
    return hw.PEAK_FLOPS_BF16


def smem_bytes_per_mac(block_m: int, dtype: Any) -> float:
    """Shared-memory bytes the tile kernels load for one multiply-add.

    f32: a thread holds a (block_m / 16) x 8 register tile and loads, for
    each feature, its block_m / 16 values of X and 8 of C (4 bytes each):
    1.0 byte a FMA at 128 rows, 1.5 at 64. 2-byte and int8 (``mma.sync``):
    a warp's tile is (block_m / 2) x 32; a 32-byte k-step loads block_m / 32
    ``ldmatrix.x4`` of X and 2 of C (512 bytes each) for (block_m / 2) x 32
    x (32 / itemsize) multiply-adds."""
    dtype = as_dtype(dtype)
    if dtype == torch.float32:
        return 4.0 * (block_m / 16 + 8) / (block_m / 16 * 8)
    item = 1 if dtype == torch.int8 else 2
    return (block_m / 32 + 2) * 512 / (block_m / 2 * 32 * (32 / item))


def model_score(m: int, k: int, f: int, p: KernelParams,
                dtype: Any = torch.float32, kind: str = "assign",
                variant: str = "generic", batch: int = 1,
                prune_rate: float = 0.5) -> float:
    """Roofline estimate (seconds) of one launch on the H100.

    ``max(ops / peak, shared-memory bytes / hw.SMEM_BW, HBM bytes /
    hw.HBM_BW)`` over a wave-quantisation factor: ``n`` thread blocks (row
    tiles x problems) run in ``ceil(n / hw.SMS)`` waves of ``hw.SMS``, and
    a partly filled last wave leaves SMs idle for its whole time.

    * ops: 2 Mp Kp Fp at the dtype's peak (f32 on the CUDA cores, bf16 /
      fp16 and int8 on the tensor cores); ``lloyd_ft`` adds the checksum
      encodings' 2 Mp Kp Fp (1 / block_m + 1 / block_k);
    * shared memory: :func:`smem_bytes_per_mac` per multiply-add;
    * HBM: X once, C once a row tile (charged at the HBM rate: an upper
      bound, as L2 serves most of it), the (min, argmin) rows; the one-pass
      kinds' entries (at most min(block_m, K) present clusters a row tile,
      Fp + 1 floats each) written and read back by the tree, the f32
      batched step's dense (Kp, Fp + 1) blocks instead;
    * ``pruned`` skips ``prune_rate`` of the distance work and X re-reads;
    * ``serve`` is ``assign`` plus ``hw.SERVE_LAUNCH_S``, one graph replay
      of a predict cell: the term the bucket ladder trades padding against;
    * ``init`` (the k-means++ round) streams X once against one centroid:
      bytes only, over ``batch`` problems.

    With ties kept by the larger tile the model picks the 128-row tile at
    large M (64 rows load 1.5x the shared memory a FMA at f32 and re-read C
    twice as often) and 64 rows where a launch fills less than one wave.
    """
    dtype = as_dtype(dtype)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "serve":
        return hw.SERVE_LAUNCH_S + model_score(
            m, k, f, p, dtype=dtype, kind="assign", variant=variant)
    m, k, f = max(m, 1), max(k, 1), max(f, 1)
    if kind == "init":
        bn = max(128, min(p.block_m, _round_up(m, 128)))
        np_ = _round_up(m, bn)
        blocks = batch * (np_ // bn)
        hbm = batch * (np_ * f + 4 * np_) * 4 / hw.HBM_BW
        waves = math.ceil(blocks / hw.SMS)
        return float(hbm * waves * hw.SMS / blocks)
    p = clamp_params(m, k, f, p)
    item = {torch.float32: 4, torch.int8: 1}.get(dtype, 2)
    mp, kp, fp = (_round_up(m, p.block_m), _round_up(k, p.block_k),
                  _round_up(f, p.block_f))
    tiles = mp // p.block_m
    blocks = batch * tiles
    macs = float(batch) * mp * kp * fp
    x_bytes = batch * mp * fp * item
    c_bytes = blocks * kp * fp * item
    hbm = x_bytes + c_bytes + batch * mp * 8
    if kind in _LLOYD_KINDS or kind == "batched":
        if kind == "batched" and dtype == torch.float32:
            hbm += 2 * blocks * kp * (fp + 1) * 4
        else:
            hbm += 2 * blocks * min(p.block_m, k) * (fp + 1) * 4
    if kind == "pruned":
        skipped = min(max(prune_rate, 0.0), 1.0)
        macs *= 1.0 - skipped
        hbm -= skipped * c_bytes
    ops_n = 2.0 * macs
    if kind == "lloyd_ft":
        ops_n += 2.0 * macs * (1.0 / p.block_m + 1.0 / p.block_k)
    t = max(ops_n / _peak(dtype),
            macs * smem_bytes_per_mac(p.block_m, dtype) / hw.SMEM_BW,
            hbm / hw.HBM_BW)
    waves = math.ceil(blocks / hw.SMS)
    return float(t * waves * hw.SMS / blocks)


def measure_score(m: int, k: int, f: int, p: KernelParams, *,
                  iters: int = 5, dtype: Any = torch.float32,
                  kind: str = "assign", variant: Optional[str] = None,
                  batch: int = 1, device: Any = "cuda") -> float:
    """Median CUDA-event time (seconds) of the real kernel path on the card
    over ``iters`` calls, after one warm-up call that keeps the lazy
    ``nvcc`` build and first-launch costs out of the timing. Inputs are
    seeded normal draws on the device; the ``pruned`` kind runs the step
    twice on cluster-sorted blobs (the first call seeds the bounds) and
    times the warmed one; ``int8`` feeds f32 data through the quantising
    entry; ``serve`` times what a service runs, one replay of the bucket's
    predict cell (a CUDA graph of the ``fused`` backend; the per-launch
    constant of the serve model stays out, as it is the same for every
    tile). The other kinds time their eager entry, host enqueue included,
    as a fit runs it. On a CPU device it raises: a plain version's time is
    not a kernel's."""
    from repro_torch.kernels import kmeanspp_init, ops
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_score times the CUDA kernels; device "
                         f"{dev} has none (use mode='model' off the card)")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    dtype = as_dtype(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def normal(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    if kind == "init":
        bn = kmeanspp_init.clamp_init_block(m, p.block_m)
        np_, fp = _round_up(m, bn), _round_up(f, 32)
        x = normal(batch, np_, fp)
        xn = (x * x).sum(2)
        c = normal(batch, 1, fp)
        d2 = xn + 1.0

        def fn():
            return kmeanspp_init.kmeanspp_round(x, xn, c, d2, block_n=bn)
    elif kind == "serve":
        from repro_torch.api.registry import get_backend
        from repro_torch.serve.compiler import ServeCompiler
        cell = ServeCompiler(get_backend("fused"), k, f, buckets=(m,),
                             dtype=dtype, params=p, device=dev).cell(m)
        cell(normal(m, f), normal(k, f))      # the inputs, one replay
        fn = cell.graph.replay
    else:
        p = clamp_params(m, k, f, p)
        in_dt = torch.float32 if kind == "int8" else dtype
        if kind == "batched":
            x, c = normal(batch, m, f, dt=in_dt), normal(batch, k, f, dt=in_dt)
            fn = _partial(ops.fused_lloyd_batched, x, c, p)
        elif kind == "pruned":
            x, c = _clustered(m, k, f, dev, in_dt)
            seeded = ops.fused_lloyd_pruned(x, c, p)
            fn = _partial(ops.fused_lloyd_pruned, x, c, p, bounds=seeded[4])
        else:
            x, c = normal(m, f, dt=in_dt), normal(k, f, dt=in_dt)
            step = {"lloyd": ops.fused_lloyd, "lloyd_ft": ops.fused_lloyd_ft,
                    "int8": ops.fused_assign_int8}.get(kind, ops.fused_assign)
            fn = _partial(step, x, c, p)
    fn()                                   # build + first launch, untimed
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    times.sort()
    return times[len(times) // 2]


def _partial(step, x, c, p, **kw):
    return lambda: step(x, c, p, **kw)


def _clustered(m: int, k: int, f: int, dev: torch.device,
               dtype: torch.dtype) -> tuple:
    """Seeded well-separated blobs with cluster-contiguous rows and
    centroids in cluster order (row tiles and centroid tiles aligned: the
    regime the pruned kind is built for)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    centers = torch.randn(k, f, generator=gen, device=dev) * 8.0
    labels = (torch.arange(m, device=dev) * k) // m
    x = centers[labels] + torch.randn(m, f, generator=gen, device=dev)
    return x.to(dtype), centers.to(dtype)


def select_params(m: int, k: int, f: int, *, mode: str = "model",
                  dtype: Any = torch.float32, kind: str = "assign",
                  space: Optional[Iterable[KernelParams]] = None,
                  batch: int = 1) -> tuple[str, KernelParams]:
    """The winning ``(variant, KernelParams)`` of one shape and kind: the
    lowest :func:`model_score` (``mode="model"``) or :func:`measure_score`
    (``mode="measure"``, on the card) among the feasible candidates, the
    larger tile on a tie."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if mode not in ("model", "measure"):
        raise ValueError(f"mode must be 'model' or 'measure', got {mode!r}")
    m, k, f = max(m, 1), max(k, 1), max(f, 1)
    variant = "batched" if kind == "batched" else "generic"
    best, best_s = None, float("inf")
    for p in (space or parameter_space(dtype, kind)):
        if not feasible(p, dtype, kind=kind, shape=(m, k, f)):
            continue
        s = (model_score(m, k, f, p, dtype=dtype, kind=kind, batch=batch)
             if mode == "model" else
             measure_score(m, k, f, p, dtype=dtype, kind=kind, batch=batch))
        if s < best_s:
            best, best_s = (variant, p), s
    if best is None:
        raise ValueError(f"no feasible {kind!r} kernel parameters for shape "
                         f"{(m, k, f)}: every built tile's shared memory "
                         f"exceeds {hw.SMEM_PER_BLOCK} bytes at this F")
    return best


def build_table(shapes: Iterable[tuple[int, int, int]], *,
                mode: str = "model", dtype: Any = torch.float32,
                path: Optional[str] = None) -> dict:
    """Deprecated, as in the reference: use
    ``AutotuneCache(path).build(shapes, mode=...)``."""
    warnings.warn("autotune.build_table is deprecated; use "
                  "repro_torch.api.AutotuneCache(path).build(...)",
                  DeprecationWarning, stacklevel=2)
    from repro_torch.api.cache import AutotuneCache, default_cache
    cache = AutotuneCache(path) if path else default_cache()
    return cache.build(shapes, mode=mode, dtype=dtype)


__all__ = ["KINDS", "as_dtype", "build_table", "feasible", "measure_score",
           "model_score", "parameter_space", "select_params", "shard_shape",
           "smem_bytes_per_mac", "tile_smem_bytes"]
