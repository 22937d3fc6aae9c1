"""Fused distance + nearest-centroid kernel (paper §III, Fig. 4) on Hopper.

Replaces the Pallas TPU kernel ``distance_argmin`` of
``src/repro/kernels/distance_argmin.py`` (bodies ``_kernel`` and
``_kernel_smallk``, epilogue ``tile_min_argmin``/``fold_min``). For padded
X (Mp, Fp), C (Kp, Fp) and centroid norms cn (Kp,) with +inf in padded
slots it returns, per row, the min of d = ||c||^2 - 2 x.c and its argmin
(lowest index on ties, the earlier centroid tile across tiles).

X and C are f32, bf16 or fp16 (one dtype, the reference's template axis);
norms, distances and the accumulator are f32.

CUDA kernels: ``lloyd_tile_kernel<BM, false, false>`` (f32) and
``lloyd_tile_mma_kernel<T, BM, false, false>`` (bf16, fp16) in
``csrc/fk_kernels.cu``. One thread block per row tile of ``block_m`` rows
walks the centroid tiles (128) and 32-feature chunks staged in shared
memory. At f32 the chunks arrive feature-major by ``cp.async`` into a
two-slot ring, the next chunk's copy under the current one's FMAs: X
transposed by 4-byte copies, C by 16-byte copies of the pre-pass's
feature-major C (:func:`prep_centroids`; X, C and cn must start on 16-byte
boundaries: ``_build.ptr(..., vec16=True)``); each
thread accumulates an 8 x 8 (BM / 16 x 8) tile of X C^T with FMAs on the
CUDA cores, one 16-byte shared load a 16 FMAs, every element one FMA chain
over the features in order; the tile's min / argmin is scanned by every
thread over its fragment and combined over the row's 16 threads by warp
shuffles (lowest index on ties: the serial scan's result bit for bit), and
one lane of the row keeps its running minimum. At bf16 /
fp16 each warp runs ``mma.sync`` m16n8k16 tiles on the tensor cores with
f32 accumulation (products of 2-byte values are exact in f32, so the plain
version's f32 product of the widened values is the same function): X's row
tile is copied once by ``cp.async`` and kept (streamed with C where it does
not fit), C's chunks run through a three-slot ``cp.async`` ring, fragments
come by ``ldmatrix``, and the min / argmin is taken in registers by the
same scan-and-combine rule (X, C and cn must start on 16-byte boundaries
at every dtype). The
reference's ``_kernel_smallk`` body (padded K of one centroid tile) needs no
body of its own here: the same loop then runs one centroid tile and folds
it once.

Bound on the H100: 2 * Mp * Kp * Fp FLOPs on the f32 CUDA cores; the bytes
(X once, C once per row tile from L2, two (M,) outputs) are far below it at
K = 1000. At bf16 / fp16 the tensor cores' 989 TFLOP/s bound the GEMM
(0.27 ms at M = 2**20, K = 1000, F = 128), near the bytes of X. The
2-byte kernel runs ``mma.sync``, not ``wgmma``: ``wgmma`` accumulates in
another order, and the kernels' outputs are held bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

def check_padded(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                 block_m: int, block_k: int, block_f: int) -> None:
    mp, fp = x.shape
    kp = c.shape[0]
    if mp % block_m or kp % block_k or fp % block_f or c.shape[1] != fp \
            or cn.shape != (kp,):
        raise ValueError(f"unpadded shapes x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}, cn {tuple(cn.shape)} vs blocks "
                         f"{(block_m, block_k, block_f)}")


def distance_argmin_plain(x: torch.Tensor, c: torch.Tensor,
                          cn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (min (M,) f32, argmin (M,) int32). The product
    runs in f32 on the widened values: a 2-byte product would round its
    output to 2 bytes, where the kernels (and the reference's MXU) keep
    f32."""
    ref.full_f32(x.device)
    return ref.first_min(cn[None, :] - 2.0 * (x.float() @ c.float().T))


# the centroid tile and feature chunk of the f32 tile kernel (kBK, kChunk)
PREP_TILE, PREP_CHUNK = 128, 32


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) on f32 tensors, element by element: a * b + c rounded
    once to f32 (round to nearest even), as the CUDA cores' FMA. a * b is
    exact in f64; the f64 sum's error is carried (TwoSum) and decides the
    one case where rounding the f64 sum to f32 rounds twice: a sum that
    lands exactly halfway between two f32 values."""
    a, b, c = (t.to(torch.float64) for t in torch.broadcast_tensors(a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    rd = r.to(torch.float64)
    away = torch.where(s > rd, torch.inf, -torch.inf).to(torch.float32)
    other = torch.nextafter(r, away)
    tie = (rd != s) & ((s - rd).abs() == (other.to(torch.float64) - s).abs())
    pick = torch.where(err > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(tie & (err != 0), pick, r)


def prep_centroids_plain(c: torch.Tensor, encodings: bool = False) -> tuple:
    """Plain version of :func:`prep_centroids`: (C feature-major, C's
    encodings or None). For each centroid tile of ``PREP_TILE`` rows and
    feature f, partial p (0..7) sums rows p, p + 8, .. in row order (e1:
    v; e2: fmaf(r + 1, v, .)), then e = 0 + part_0 + .. + part_7: the
    kernel's order, so the bits are its."""
    ct = c.transpose(-1, -2).contiguous()
    if not encodings:
        return ct, None
    kp, fp = c.shape[-2:]
    nkt, steps = kp // PREP_TILE, PREP_TILE // 8
    cv = c.view(*c.shape[:-2], nkt, steps, 8, fp)    # row 8 k + p: (k, p)
    a1 = torch.zeros(cv[..., 0, :, :].shape, dtype=torch.float32,
                     device=c.device)
    a2 = torch.zeros_like(a1)
    for k in range(steps):
        v = cv[..., k, :, :]
        w = (8 * k + 1 + torch.arange(8, device=c.device,
                                      dtype=torch.float32))[:, None]
        a1 = a1 + v
        a2 = fma_f32(w, v, a2)
    e1 = torch.zeros(a1[..., 0, :].shape, dtype=torch.float32,
                     device=c.device)
    e2 = torch.zeros_like(e1)
    for q in range(8):
        e1 = e1 + a1[..., q, :]
        e2 = e2 + a2[..., q, :]
    return ct, torch.stack((e1, e2), -2)


def prep_centroids(c: torch.Tensor, encodings: bool = False) -> tuple:
    """The f32 tile kernel's pre-pass (``lloyd_prep_kernel``), once a call:
    c (Kp, Fp) or a stack (B, Kp, Fp) of f32 centroids -> (ct: C
    feature-major, (.., Fp, Kp), the operand the f32 kernels stage 16 bytes
    at a time; cenc: with ``encodings``, C's e1 / e2 encodings per
    centroid tile, (.., Kp / 128, 2, Fp), the FT kernels' expected row
    checksums' operand; else None). CPU tensors take the plain version."""
    if c.dtype != torch.float32 or c.dim() not in (2, 3) \
            or c.shape[-2] % PREP_TILE or c.shape[-1] % PREP_CHUNK:
        raise ValueError(f"prep_centroids takes f32 centroids padded to "
                         f"({PREP_TILE}, {PREP_CHUNK}), got {c.dtype} "
                         f"{tuple(c.shape)}")
    if _build.on_cpu(c):
        return prep_centroids_plain(c, encodings)
    kp, fp = c.shape[-2:]
    lead = tuple(c.shape[:-2])
    ct = torch.empty(lead + (fp, kp), dtype=torch.float32, device=c.device)
    cenc = torch.empty(lead + (kp // PREP_TILE, 2, fp), dtype=torch.float32,
                       device=c.device) if encodings else None
    code = _build.library().lib.fk_lloyd_prep(
        _build.ptr(c, torch.float32, "c"), ct.data_ptr(),
        None if cenc is None else cenc.data_ptr(),
        c.shape[0] if c.dim() == 3 else 1, kp, fp, _build.stream_of(c))
    _build.check(code, "prep_centroids")
    prep_centroids.launches += 1
    return ct, cenc


prep_centroids.launches = 0


def c_operand(c: torch.Tensor) -> torch.Tensor:
    """What a tile kernel stages of C: the pre-pass's ct at f32 (CUDA), C
    itself at 2 bytes."""
    return prep_centroids(c)[0] if c.dtype == torch.float32 else c


def distance_argmin(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor, *,
                    block_m: int, block_k: int, block_f: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw kernel entry on pre-padded inputs: X and C f32, bf16 or fp16 (one
    dtype), cn f32. CPU tensors take the plain version; CUDA tensors launch
    the kernel of their dtype. Returns (min (Mp,) f32, argmin (Mp,))."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    dt = _build.input_dtype(x, c)
    if _build.on_cpu(x, c, cn):
        return distance_argmin_plain(x, c, cn)
    mp, fp = x.shape
    mind = torch.empty(mp, dtype=torch.float32, device=x.device)
    am = torch.empty(mp, dtype=torch.int32, device=x.device)
    c_op = c_operand(c)
    code = _build.launch(
        "fk_distance_argmin", dt, _build.ptr(x, dt, "x", vec16=True),
        _build.ptr(c_op, dt, "c", vec16=True),
        _build.ptr(cn, torch.float32, "cn", vec16=True),
        mind.data_ptr(), am.data_ptr(), mp, c.shape[0], fp, block_m, block_f,
        _build.stream_of(x))
    _build.check(code, "distance_argmin")
    distance_argmin.launches += 1
    return mind, am


distance_argmin.launches = 0


def tile_resources(block_m: int, ft: bool, update: int, fp: int, *,
                   kp: int = 1024, dtype=torch.float32) -> dict:
    """A tile kernel on the card, ``lloyd_tile_kernel<block_m, ft,
    update>`` (f32) or ``lloyd_tile_mma_kernel<T, block_m, ft, update>``
    (bf16, fp16; update 0 none, 1 dense (f32), 2 entries, 3 batched
    entries (2 bytes), 4 pruned entries): resident blocks an SM at Fp =
    ``fp`` and Kp = ``kp``, registers and local-memory (spill) bytes a
    thread, and its dynamic shared memory. Needs a CUDA card (the
    library's build)."""
    import ctypes
    out = (ctypes.c_int * 4)()
    half = _build.HALF_KINDS.get(str(dtype).replace("torch.", ""), -1)
    code = _build.library().lib.fk_tile_resources(block_m, int(ft), update,
                                                  fp, kp, half, out)
    _build.check(code, "tile_resources")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))
