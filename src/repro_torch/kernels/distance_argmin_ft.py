"""Fault-tolerant fused distance + argmin kernel (paper §IV, Fig. 6).

Replaces the Pallas TPU kernel ``distance_argmin_ft`` of
``src/repro/kernels/distance_argmin_ft.py`` (``_kernel``): the fused
distance kernel with the dual-checksum ABFT. While feature chunks stream,
the expected checksums of D = X C^T accumulate from the resident tiles

    col1 += (e1^T X) C^T   col2 += (e2^T X) C^T
    row1 += X (C^T e1)     row2 += X (C^T e2)      e1 = 1, e2 = 1..b

At the verification interval -- one (row tile, centroid tile) pair over
all features, addressed by ``KernelParams`` exactly as on the TPU -- the
observed checksums of the accumulator are compared against
``threshold_factor(Fp, dtype) * max(max|col1|, max|row1|, 1)``; a fault is
located by the e2/e1 ratio, corrected in place, and the min/argmin runs on
the corrected tile. An 8-word descriptor plants one fault; the kernel
returns the detections per row tile.

CUDA kernels: ``lloyd_tile_kernel<BM, true, kNoUpdate>`` (f32) and
``lloyd_tile_mma_kernel<T, BM, true, kNoUpdate>`` (bf16, fp16) in
``csrc/fk_kernels.cu``; the descriptor is injected after the last chunk of
feature tile ``f_tile``, as on the TPU (at bf16 / fp16 into the ``mma.sync``
fragment element of the lane that holds it). X and C are f32, bf16 or fp16;
the checksums run in f32 on the widened tiles, as the reference's
``xf``/``cf`` casts, and ``factor`` is the caller's
``threshold_factor(Fp, input dtype)``: 16 sqrt(Fp) max(eps_in, eps_f32),
8,192x (fp16) to 65,536x (bf16) f32's. At f32 the expected checksums are
CUDA-core FMAs on the staged chunks, against C's encodings from the
pre-pass (``distance_argmin.prep_centroids``, once a call, which also
gives C feature-major) and X's, computed once a row tile; the observed ones
are a pass over the tile in shared memory. At bf16 / fp16 they follow the
paper's tensor-core
scheme: :func:`encode_centroids` (``lloyd_encode_kernel<T>``, once a call)
gives C's e1 / e2 encodings per centroid tile split into three 2-byte parts
(``matmul_abft.split_encodings``), and the expected row checksums are one
more ``mma.sync`` fragment beside the product; X's encodings are computed
once a row tile (kept in shared memory) and the expected column checksums are
FMAs on them; the observed checksums are sums over the stored tile in
shared memory, a row's inside its min/argmin pass and a column's by one
thread a column (summing them from the accumulator registers by warp
shuffles was tried and dropped: it spilled registers and ran slower).
Bound on the H100: the distance GEMM, as
``distance_argmin``; the checksums add O((bm + bk) * Fp) work per tile.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.distance_argmin import check_padded, prep_centroids

# the centroid tile the C encodings run over (the CUDA kernels' kBK)
ENC_TILE = 128

# [enabled, m_tile, c_tile, f_tile, row_in_tile, col_in_tile, delta bits, 0]
INJ_LEN = 8


def f32_bits(delta: float) -> int:
    return int(np.float32(delta).view(np.int32))


def no_injection() -> torch.Tensor:
    return torch.zeros(INJ_LEN, dtype=torch.int32)


def make_injection(m_tile: int, c_tile: int, f_tile: int, row: int, col: int,
                   delta: float) -> torch.Tensor:
    """Build a descriptor (delta carried bit-cast in an int32)."""
    return torch.tensor([1, m_tile, c_tile, f_tile, row, col, f32_bits(delta),
                         0], dtype=torch.int32)


def abft_correct_plain(acc: torch.Tensor, x: torch.Tensor, c: torch.Tensor,
                       inj: torch.Tensor, block_m: int, block_k: int,
                       block_f: int, factor: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain ABFT over every (row tile, centroid tile) interval of the
    product ``acc`` = x c^T (Mp, Kp): plant the descriptor's distance-slot
    fault (words 0..6), detect, locate by the e2/e1 ratio and correct.
    Returns (corrected acc, detections per row tile (Mp/bm,) int32). The
    fault is added to the finished product, not after feature tile
    ``f_tile``; the detection and correction rules are the kernel's. The
    expected checksums run in f32 on the widened x and c."""
    x, c = x.float(), c.float()
    dev = acc.device
    mp, kp = acc.shape
    fp = x.shape[1]
    bm, bk = block_m, block_k
    nmt, nkt = mp // bm, kp // bk
    w_m = torch.arange(1, bm + 1, dtype=torch.float32, device=dev)
    w_k = torch.arange(1, bk + 1, dtype=torch.float32, device=dev)
    # simulated SEU: one element, when the descriptor addresses a real one
    delta = inj[6:7].view(torch.float32)
    hit = ((inj[0] > 0) & (inj[1] >= 0) & (inj[1] < nmt) & (inj[2] >= 0)
           & (inj[2] < nkt) & (inj[3] >= 0) & (inj[3] < fp // block_f)
           & (inj[4] >= 0) & (inj[4] < bm) & (inj[5] >= 0) & (inj[5] < bk))
    row = (inj[1] * bm + inj[4]).clamp(0, mp - 1).long().view(1)
    col = (inj[2] * bk + inj[5]).clamp(0, kp - 1).long().view(1)
    acc = acc.clone()
    acc.index_put_((row, col), torch.where(hit, delta, 0.0), accumulate=True)
    # expected checksums from the inputs
    xv = x.view(nmt, bm, fp)
    cv = c.view(nkt, bk, fp)
    e1x, e2x = xv.sum(1), (w_m[None, :, None] * xv).sum(1)     # (nmt, fp)
    ce1, ce2 = cv.sum(1), (w_k[None, :, None] * cv).sum(1)     # (nkt, fp)
    col1 = (e1x @ c.T).view(nmt, nkt, bk)
    col2 = (e2x @ c.T).view(nmt, nkt, bk)
    row1 = (x @ ce1.T).view(nmt, bm, nkt).permute(0, 2, 1)
    row2 = (x @ ce2.T).view(nmt, bm, nkt).permute(0, 2, 1)
    # observed checksums of every tile, (nmt, nkt, bm, bk)
    accv = acc.view(nmt, bm, nkt, bk).permute(0, 2, 1, 3)
    res_c1 = accv.sum(2) - col1
    res_c2 = (w_m[:, None] * accv).sum(2) - col2
    res_r1 = accv.sum(3) - row1
    res_r2 = (w_k * accv).sum(3) - row2
    scale = torch.maximum(torch.maximum(col1.abs().amax(-1),
                                        row1.abs().amax(-1)),
                          torch.ones((), device=dev))
    thr = torch.tensor(factor, dtype=torch.float32, device=dev) * scale
    detected = (res_c1.abs().amax(-1) > thr) | (res_r1.abs().amax(-1) > thr)

    def pick(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return a.gather(-1, i[..., None])[..., 0]

    def ratio_index(num: torch.Tensor, den: torch.Tensor, n: int):
        safe = torch.where(den == 0.0, 1.0, den)
        r = torch.round(num / safe) - 1.0
        return r.nan_to_num(-1.0).clamp(-1.0, float(n)).long().clamp(0, n - 1)

    j = res_c1.abs().argmax(-1)
    d_col = pick(res_c1, j)
    use_ratio = d_col.abs() > thr
    i = torch.where(use_ratio, ratio_index(pick(res_c2, j), d_col, bm),
                    res_r1.abs().argmax(-1))
    d_row = pick(res_r1, i)
    dlt = torch.where(d_col.abs() > d_row.abs(), d_col, d_row)
    j = torch.where(use_ratio, j, ratio_index(pick(res_r2, i), d_row, bk))
    rows = (torch.arange(nmt, device=dev)[:, None] * bm + i).reshape(-1)
    cols = (torch.arange(nkt, device=dev)[None, :] * bk + j).reshape(-1)
    fix = torch.where(detected, dlt, 0.0).reshape(-1)
    acc[rows, cols] = acc[rows, cols] - fix
    return acc, detected.sum(1).to(torch.int32)


def distance_argmin_ft_plain(x, c, cn, inj, block_m, block_k, block_f,
                             factor):
    """Plain PyTorch version: (min (Mp,), argmin (Mp,), det (Mp/bm,)); the
    product in f32 on the widened values, as :func:`distance_argmin_plain`."""
    ref.full_f32(x.device)
    acc, det = abft_correct_plain(x.float() @ c.float().T, x, c, inj,
                                  block_m, block_k, block_f, factor)
    mind, am = ref.first_min(cn[None, :] - 2.0 * acc)
    return mind, am, det


def encode_centroids_plain(c: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`encode_centroids`: e1 = sum_j C[j] and e2 =
    sum_j (j + 1) C[j] over each centroid tile of ``ENC_TILE`` rows of c
    (Kp, Fp), summed in j order in f32 (the kernel's order: each (j + 1) v
    is exact, so its fma rounds once, as this add does), then split as
    ``matmul_abft.split_encodings`` (Kp / 128, 8, Fp) in c's dtype."""
    from repro_torch.kernels.matmul_abft import split_encodings
    kp, fp = c.shape
    cv = c.float().view(kp // ENC_TILE, ENC_TILE, fp)
    e1 = torch.zeros((kp // ENC_TILE, fp), device=c.device)
    e2 = torch.zeros_like(e1)
    for j in range(ENC_TILE):
        e1 = e1 + cv[:, j]
        e2 = e2 + (j + 1) * cv[:, j]
    return split_encodings(torch.stack((e1, e2), -1), ENC_TILE, c.dtype)


def encode_centroids(c: torch.Tensor) -> torch.Tensor:
    """The 2-byte FT kernels' pre-pass (``lloyd_encode_kernel<T>``): C's
    split e1 / e2 encodings per centroid tile, (Kp / 128, 8, Fp) in c's
    dtype (bf16 or fp16), the B operand of the row checksums' extra MMA.
    Once a call: they depend on C alone."""
    kp, fp = c.shape
    if c.dtype not in (torch.bfloat16, torch.float16) or kp % ENC_TILE:
        raise ValueError(f"encode_centroids takes bf16 / fp16 centroids "
                         f"padded to {ENC_TILE} rows, got {c.dtype} "
                         f"{tuple(c.shape)}")
    if _build.on_cpu(c):
        return encode_centroids_plain(c)
    cenc = torch.empty((kp // ENC_TILE, 8, fp), dtype=c.dtype,
                       device=c.device)
    code = _build.library().lib.fk_lloyd_encode_lp(
        _build.ptr(c, c.dtype, "c"), _build.ptr(cenc, c.dtype, "cenc"), kp,
        fp, _build.HALF_KINDS[str(c.dtype).replace("torch.", "")],
        _build.stream_of(c))
    _build.check(code, "encode_centroids")
    encode_centroids.launches += 1
    return cenc


encode_centroids.launches = 0


def ft_scratch(x: torch.Tensor, c: torch.Tensor) -> tuple:
    """(C operand, C encodings) of an FT launch: at f32 the pre-pass's ct
    and encodings (``distance_argmin.prep_centroids``), at 2 bytes C and
    its split encodings (:func:`encode_centroids`). X's encodings stay in
    the kernels' shared memory."""
    if x.dtype == torch.float32:
        return prep_centroids(c, encodings=True)
    return c, encode_centroids(c)


def distance_argmin_ft(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor,
                       inj: torch.Tensor, *, block_m: int, block_k: int,
                       block_f: int, factor: float):
    """Raw FT kernel entry on pre-padded inputs (X and C f32, bf16 or fp16);
    ``inj`` is an int32 descriptor on the data's device and ``factor`` the
    static part of the detection threshold. Returns (min (Mp,), argmin
    (Mp,), det (Mp/bm,))."""
    check_padded(x, c, cn, block_m, block_k, block_f)
    dt = _build.input_dtype(x, c)
    if inj.shape[0] < 7:
        raise ValueError(f"injection descriptor too short: {inj.shape}")
    if _build.on_cpu(x, c, cn, inj):
        return distance_argmin_ft_plain(x, c, cn, inj, block_m, block_k,
                                        block_f, factor)
    mp, fp = x.shape
    dev = x.device
    mind = torch.empty(mp, dtype=torch.float32, device=dev)
    am = torch.empty(mp, dtype=torch.int32, device=dev)
    det = torch.empty(mp // block_m, dtype=torch.int32, device=dev)
    c_op, cenc = ft_scratch(x, c)
    code = _build.launch(
        "fk_distance_argmin_ft", dt, _build.ptr(x, dt, "x", vec16=True),
        _build.ptr(c_op, dt, "c", vec16=True),
        _build.ptr(cn, torch.float32, "cn", vec16=True),
        _build.ptr(cenc, cenc.dtype, "cenc"),
        _build.ptr(inj, torch.int32, "inj"),
        mind.data_ptr(), am.data_ptr(), det.data_ptr(), factor, mp,
        c.shape[0], fp, block_m, block_f, _build.stream_of(x))
    _build.check(code, "distance_argmin_ft")
    distance_argmin_ft.launches += 1
    return mind, am, det


distance_argmin_ft.launches = 0
