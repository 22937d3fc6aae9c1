"""Flash attention (online-softmax GQA attention) on Hopper.

Replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (body ``_kernel``): q (B, H, Sq,
hd) against k, v (B, KV, Skv, hd), query head h reading KV head
h // (H / KV), masked by absolute positions with the mask contract of
``models.attention.attend``:

    valid = kpos >= 0 & (causal -> kpos <= qpos) & (window -> kpos > qpos - window)

The kernel computes what the reference kernel computes: unscaled scores in
f32, masked scores set to the finite ``NEG``, p = exp(s - running max) cast
to v's dtype before the P V product, f32 accumulation, the division by the
denominator at the end. So a query row with no valid key returns the mean
of v over all keys (exp(NEG - NEG) = 1), as the reference kernel does, or
zero with ``zero_empty_rows=True`` (``attend``'s contract; the kernel
writes the zero itself, so ``attend`` builds no mask on the card).

CUDA kernels in ``csrc/fk_attention.cu``; the C side picks one from Sq,
the dtype and the head dim (``hw.FLASH_*``), see the source for the design
and the bounds:

* ``flash_decode_kernel`` at Sq <= ``hw.FLASH_DECODE_MAX_SQ`` (16), every
  dtype: split-KV with GQA packing. One block per (batch, KV head, row
  chunk, split) takes the group x Sq query rows of that KV head, so each
  K/V byte is read once per launch; f32 partials (m, l, acc), combined by
  the last block of each (batch, KV head, row chunk) to finish. The wrapper
  allocates the partials and keeps the block tickets per device and
  stream (the kernel leaves them zero).
* ``flash_prefill_kernel`` for bf16 / fp16 at Sq > 16, head dims 64, 128
  and 256: 128-row query tiles, two warpgroups on ``wgmma`` fed by a
  producer warp's TMA loads through an ``mbarrier`` ring.
* ``flash_f32_kernel`` for f32 at Sq > 16: f32 FMAs on the CUDA cores, a
  block packing the query heads of a GQA group (:func:`f32_tiles`) so one
  K / V tile serves them all, K / V on a two-stage ``cp.async`` ring.

Every kernel skips KV tiles that no query of the tile sees and leaves the
mask out of tiles that every query sees whole, decided from the positions
(:func:`live_tiles` states the rule); :func:`flash_split_plain` states the
decode kernel's split-and-combine walk and :func:`flash_f32_walk_plain`
the f32 kernel's walk. They are plain PyTorch for the tests: nothing on
the card's path calls them.

Every kernel reads q, k, v and writes the output through their (batch,
head, sequence) strides, so transposed views of (B, S, H, hd) tensors need
no copy, and masks the ragged ends of Sq and Skv itself: unlike the
reference, no shape must be padded to a tile. Head dims other than 64,
128 and 256 are zero-padded to the next of them (a copy).

On the CPU the wrapper runs :func:`flash_attention_plain`, the masked
softmax of the reference's test oracle with the kernel's finite ``NEG``.
A CUDA tensor launches the kernel or raises; the wrapper counts its calls
that launch (``flash_attention.launches``) and, by kernel,
``flash_attention.kernel_launches``.

The gradient. The reference trains through XLA's autodiff of the plain
attention; its Pallas kernel has no backward. The port's kernel writes its
result through ctypes, outside autograd, so :class:`FlashAttentionFn`
carries it: with grad mode on and q, k or v requiring grad,
:func:`flash_attention` runs the prefill kernel (bf16 / fp16) or the f32
kernel with a row log-sum-exp output (``lse``, every Sq) and its backward
:func:`flash_attention_backward` launches three kernels. At bf16 / fp16
those of ``csrc/fk_attention_bwd.cu``: ``flash_bwd_prep_kernel`` (D =
rowsum(P o dP), the dQ kernel's walk without its product,
:func:`flash_bwd_prep`), ``flash_bwd_dkdv_kernel``
(:func:`flash_bwd_dkdv`) and ``flash_bwd_dq_kernel`` (:func:`flash_bwd_dq`),
each wrapper counting its launches in ``.launches`` (the hd-256
instantiations also in ``.launches_hd256``). The last two are Hopper's
shape: two consumer warpgroups on ``wgmma`` fed through a TMA ring by a
producer warp, blocks of :data:`BWD_BLOCK` keys (dK / dV; 64 at hd 256,
where the warpgroups split hd) or query rows (dQ), :data:`BWD_ROWS` a
warpgroup, walking steps of :data:`BWD_TILE` query rows (dK / dV) or keys
(dQ; 32 at hd 256) by the tile rule of :func:`live_tiles`; no atomics, so
two launches give the same bits. At f32 those of
``csrc/fk_attention_bwd_f32.cu`` on the CUDA cores
(:func:`flash_bwd_f32_prep`, :func:`flash_bwd_f32_dkdv`,
:func:`flash_bwd_f32_dq`, the f32 forward's tiles). Under ``no_grad``
serving keeps its launch: no lse, the same bits. The backward takes every
dtype and head dim the forward takes (up to :data:`GRAD_MAX_HEAD_DIM`)
under ``attend``'s contract, ``zero_empty_rows=True`` (a row with no valid
key is a zero output: zero dq, nothing to dk or dv); with grad on the card
``zero_empty_rows=False`` raises :class:`FlashGradUnsupported`.
:func:`flash_attention_backward_plain` is its plain version in f32 (the
tests' and ``chip_smoke.py``'s; on the CPU the function's launches run the
plain versions).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import hw
from repro_torch.kernels import _build, ref

NEG = -1e30
# the C entry point's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# live_tiles' classes of a (query tile, KV tile) pair
DEAD, LIVE, FULL = 0, 1, 2


def position_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                  causal: bool, window: int) -> torch.Tensor:
    """(Sq, Skv) validity of each key for each query, by absolute position."""
    m = (kv_positions >= 0)[None, :]
    if causal:
        m = m & (kv_positions[None, :] <= q_positions[:, None])
    if window:
        m = m & (kv_positions[None, :] > q_positions[:, None] - window)
    return m


def flash_attention_plain(q, k, v, q_positions, kv_positions, *,
                          causal: bool = True, window: int = 0,
                          zero_empty_rows: bool = False):
    """Plain PyTorch version: the full masked softmax in f32 (scores with
    the finite ``NEG`` where masked), cast to q's dtype."""
    ref.full_f32(q.device)
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kk.transpose(-1, -2))
    mask = position_mask(q_positions, kv_positions, causal, window)
    s = torch.where(mask, s, torch.tensor(NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    if zero_empty_rows:
        p = p * mask.any(dim=-1, keepdim=True)
    return torch.matmul(p, vv).to(q.dtype)


def flash_lse_plain(q, k, q_positions, kv_positions, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp over its valid keys' scores q . k in f32,
    (B, H, Sq); +inf for a row with no valid key (the kernel's ``lse``)."""
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kk.transpose(-1, -2))
    mask = position_mask(q_positions, kv_positions, causal, window)
    s = torch.where(mask, s, torch.tensor(-float("inf"), device=s.device))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(mask.any(-1), lse, torch.tensor(float("inf"),
                                                       device=s.device))


def flash_attention_backward_plain(q, k, v, o, do, lse, q_positions,
                                   kv_positions, *, causal: bool = True,
                                   window: int = 0,
                                   zero_empty_rows: bool = True,
                                   round_to: torch.dtype | None = None):
    """Plain PyTorch gradient of :func:`flash_attention` in f32, from its
    row log-sum-exp ``lse``: P = exp(S - lse) on the valid pairs, dV = P^T
    dO, dP = dO V^T, D = rowsum(P o dP) (:func:`flash_bwd_prep_plain`),
    dS = P o (dP - D), dQ = dS K, dK = dS^T Q, dK and dV summed over each KV
    head's group. ``o``, the forward's output, is not read: the f32 kernels
    take D = rowsum(dO o O), equal to it up to f32 rounding (at bf16 / fp16
    O's rounding would leave each row of dS summing to dO . (O - P V), not
    to zero; ``csrc/fk_attention_bwd.cu``'s header).
    Returns (dq, dk, dv) in q's, k's and v's dtypes. A row with no valid key
    (lse = +inf) gets zero dq and adds nothing to dk and dv; without
    ``zero_empty_rows`` its output was the mean of v, which adds dO / Skv
    to every key's dv. ``round_to`` rounds P and dS to that dtype before
    their products, where the kernels do (the rounding floor of the
    kernels' arithmetic). f64 inputs are computed in f64 (the f32
    kernels' reference)."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, dof = q.to(ct), do.to(ct)
    kk = k.to(ct).repeat_interleave(g, dim=1)
    vv = v.to(ct).repeat_interleave(g, dim=1)
    s = torch.matmul(qf, kk.transpose(-1, -2))
    mask = position_mask(q_positions, kv_positions, causal, window)
    p = torch.where(mask, torch.exp(s - lse.to(ct)[..., None]),
                    torch.zeros((), dtype=ct, device=s.device))
    dp = torch.matmul(dof, vv.transpose(-1, -2))
    dsum = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    if round_to is not None:
        p, ds = p.to(round_to).to(ct), ds.to(round_to).to(ct)
    dq = torch.matmul(ds, kk)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.view(b, kvh, g, skv, hd).sum(2)
    dv = dv.view(b, kvh, g, skv, hd).sum(2)
    if not zero_empty_rows:
        empty = ~mask.any(-1)                              # (Sq,)
        mean = (dof * empty[:, None]).sum(2).view(b, kvh, g, hd).sum(2)
        dv = dv + (mean / skv)[:, :, None, :]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_prep_plain(q, k, v, do, lse, q_positions, kv_positions, *,
                         causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """:func:`flash_bwd_prep`'s plain version: D = rowsum(P o dP) in f32,
    (B, H, Sq)."""
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kk.transpose(-1, -2))
    mask = position_mask(q_positions, kv_positions, causal, window)
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=s.device))
    return (p * torch.matmul(do.float(), vv.transpose(-1, -2))).sum(-1)


def live_tiles(q_positions: torch.Tensor, kv_positions: torch.Tensor,
               block_q: int, block_k: int, causal: bool,
               window: int) -> torch.Tensor:
    """The kernels' tile rule: (ceil(Sq / block_q), ceil(Skv / block_k))
    classes of (query tile, KV tile) pairs, from the valid keys' (kpos >= 0)
    kmin / kmax / count and the query tile's qmin / qmax.

    DEAD when no key of the tile is valid, or causal and kmin > qmax, or a
    window and kmax <= qmin - window: no query of the tile sees a key of it.
    FULL when all block_k keys exist and are valid, causal -> kmax <= qmin
    and window -> kmin > qmax - window: every query sees every key. LIVE
    otherwise. The kernels decide it per tile, on the card."""
    qp = q_positions.to(torch.int64)
    kp = kv_positions.to(torch.int64)
    sq, skv = qp.shape[0], kp.shape[0]
    nq, nk = -(-sq // block_q), -(-skv // block_k)
    big = 1 << 62
    qlo = F.pad(qp, (0, nq * block_q - sq), value=big).view(nq, block_q)
    qhi = F.pad(qp, (0, nq * block_q - sq), value=-big).view(nq, block_q)
    qmin, qmax = qlo.min(1).values[:, None], qhi.max(1).values[:, None]
    kt = F.pad(kp, (0, nk * block_k - skv), value=-1).view(nk, block_k)
    valid = kt >= 0
    cnt = valid.sum(1)[None, :]
    kmin = torch.where(valid, kt, big).min(1).values[None, :]
    kmax = torch.where(valid, kt, -big).max(1).values[None, :]
    dead = cnt == 0
    full = cnt == block_k
    if causal:
        dead = dead | (kmin > qmax)
        full = full & (kmax <= qmin)
    if window:
        dead = dead | (kmax <= qmin - window)
        full = full & (kmin > qmax - window)
    cls = torch.where(full, FULL, LIVE).expand(nq, nk)
    return torch.where(dead, DEAD, cls).to(torch.int8)


def flash_split_plain(q, k, v, q_positions, kv_positions, *,
                      causal: bool = True, window: int = 0,
                      zero_empty_rows: bool = False, splits: int = 4,
                      block_k: int = 64) -> torch.Tensor:
    """The decode kernel's walk in plain PyTorch (q (B, H, Sq, hd); k, v
    (B, KV, Skv, hd)), in f32: the KV tiles of ``block_k`` keys cut into
    ``splits`` runs of whole tiles; per split an online softmax over its
    tiles that :func:`live_tiles` does not call DEAD for the Sq queries
    (masked in LIVE tiles only), p rounded to v's dtype before P V, giving
    partials (m, l, acc); a row with no valid key in a split (m = NEG) and
    not ``zero_empty_rows`` takes acc = the sum of v over the split's keys
    and l = their count. The combine: M = max m_s, w_s = exp(m_s - M),
    out = sum w_s acc_s / max(sum w_s l_s, 1e-30), zero where M = NEG with
    ``zero_empty_rows``."""
    g = q.shape[1] // k.shape[1]
    qf = q.float()
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    skv = kk.shape[2]
    cls = live_tiles(q_positions, kv_positions, q.shape[2], block_k,
                     causal, window)[0]
    mask = position_mask(q_positions, kv_positions, causal, window)
    ntiles = cls.shape[0]
    per = -(-ntiles // splits)
    neg = torch.tensor(NEG, device=q.device)
    parts = []
    for t0 in range(0, ntiles, per):
        m = torch.full(qf.shape[:3], NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for t in range(t0, min(t0 + per, ntiles)):
            if cls[t] == DEAD:
                continue
            sl = slice(t * block_k, min((t + 1) * block_k, skv))
            s = torch.matmul(qf, kk[:, :, sl].transpose(-1, -2))
            if cls[t] == LIVE:
                s = torch.where(mask[:, sl], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(-1)
            acc = acc * scale[..., None] + torch.matmul(
                p.to(v.dtype).float(), vv[:, :, sl])
            m = m_new
        if not zero_empty_rows:
            keys = slice(t0 * block_k, min((t0 + per) * block_k, skv))
            empty = (m == NEG)[..., None]
            acc = torch.where(empty, vv[:, :, keys].sum(2, keepdim=True), acc)
            l = torch.where(empty[..., 0], float(keys.stop - keys.start), l)
        parts.append((m, l, acc))
    ms = torch.stack([p[0] for p in parts])
    big_m = ms.amax(0)
    w = torch.exp(ms - big_m)
    den = (w * torch.stack([p[1] for p in parts])).sum(0)
    num = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    out = num / den.clamp(min=1e-30)[..., None]
    if zero_empty_rows:
        out = torch.where((big_m == NEG)[..., None], 0.0, out)
    return out.to(q.dtype)


# GQA heads one f32 block packs, most (csrc/fk_attention.cu: kF32MaxHeads)
F32_MAX_HEADS = 8


def f32_tiles(hd: int, group: int) -> tuple[int, int, int]:
    """The f32 kernel's tiles at a head dim of 64, 128 or 256 and a GQA
    group: (heads a block packs, the largest power of two dividing the
    group up to ``F32_MAX_HEADS``; query positions a block, its rows over
    the heads; keys a KV tile)."""
    rows, bk = hw.FLASH_F32_ROWS, hw.FLASH_F32_BLOCK_K
    if hd > 128:
        rows, bk = rows // 2, bk // 2
    hb = 1
    while hb < F32_MAX_HEADS and group % (2 * hb) == 0:
        hb *= 2
    return hb, rows // hb, bk


def f32_resources(hd: int) -> dict:
    """``flash_f32_kernel<hd>`` on the card: resident blocks an SM,
    registers and local-memory (spill) bytes a thread, dynamic shared
    bytes. Needs a CUDA card (the library's build)."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library("fk_attention").lib.fk_flash_f32_resources(
        hd, out), "flash_f32 resources", "fk_attention")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))


def flash_f32_walk_plain(q, k, v, q_positions, kv_positions, *,
                         causal: bool = True, window: int = 0,
                         zero_empty_rows: bool = False) -> torch.Tensor:
    """The f32 kernel's walk in plain PyTorch (q (B, H, Sq, hd); k, v (B,
    KV, Skv, hd); f32): blocks of :func:`f32_tiles` ``hb`` heads of one GQA
    group x ``pb`` query positions, packed head-major into rows; per block
    the KV tiles of ``bk`` keys in order, those :func:`live_tiles` calls
    DEAD for the block's positions skipped, the mask applied in LIVE tiles
    only; per tile s = q k^T, m_new = max(m, rowmax s), p = exp(s - m_new),
    l = l exp(m - m_new) + sum p, acc = acc exp(m - m_new) + p v; a row
    left with m = NEG is zero with ``zero_empty_rows``, else the mean of v
    over all keys; out = acc / max(l, 1e-30)."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    hdp = next(d for d in hw.FLASH_HEAD_DIMS if d >= hd)
    hb, pb, bk = f32_tiles(hdp, g)
    qf = q.float().view(b, kvh, g // hb, hb, sq, hd)
    kf, vf = k.float(), v.float()
    mask = position_mask(q_positions, kv_positions, causal,
                         window).expand(sq, skv)
    neg = torch.tensor(NEG, device=q.device)
    out = torch.empty(b, kvh, g // hb, hb, sq, hd, device=q.device)
    for q0 in range(0, sq, pb):
        qs = slice(q0, min(q0 + pb, sq))
        n = qs.stop - q0
        cls = live_tiles(q_positions[qs], kv_positions, pb, bk, causal,
                         window)[0]
        rmask = mask[qs].repeat(hb, 1)          # packed rows: head-major
        for run in range(g // hb):
            x = qf[:, :, run, :, qs].reshape(b, kvh, hb * n, hd)
            m = torch.full(x.shape[:3], NEG, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(x)
            for t in range(cls.shape[0]):
                if cls[t] == DEAD:
                    continue
                ks = slice(t * bk, min((t + 1) * bk, skv))
                s = torch.matmul(x, kf[:, :, ks].transpose(-1, -2))
                if cls[t] == LIVE:
                    s = torch.where(rmask[:, ks], s, neg)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                scale = torch.exp(m - m_new)
                l = l * scale + p.sum(-1)
                acc = acc * scale[..., None] + torch.matmul(p, vf[:, :, ks])
                m = m_new
            empty = (m == NEG)[..., None]
            o = acc / l.clamp(min=1e-30)[..., None]
            o = torch.where(empty, 0.0 if zero_empty_rows
                            else vf.mean(2, keepdim=True), o)
            out[:, :, run, :, qs] = o.view(b, kvh, hb, n, hd)
    return out.view(b, h, sq, hd).to(q.dtype)


def _check_shapes(q, k, v, q_positions, kv_positions, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        raise ValueError(f"q (B, H, Sq, hd), k and v (B, KV, Skv, hd) with H "
                         f"a multiple of KV; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if tuple(q_positions.shape) != (q.shape[2],) \
            or tuple(kv_positions.shape) != (k.shape[2],):
        raise ValueError(f"positions must be (Sq,) and (Skv,); got "
                         f"{tuple(q_positions.shape)}, "
                         f"{tuple(kv_positions.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _strides(t: torch.Tensor, what: str) -> list[int]:
    """(batch, head, sequence) element strides of a tensor the kernel can
    address: contiguous head dim, 16-byte aligned rows and base."""
    align = 16 // t.element_size()
    st = list(t.stride()[:3])
    if t.stride(3) != 1 or any(s % align for s in st) \
            or t.data_ptr() % 16:
        raise ValueError(f"{what} must have a contiguous head dim and "
                         f"16-byte aligned rows; strides {tuple(t.stride())}")
    return st


class FlashGradUnsupported(NotImplementedError):
    """A gradient of :func:`flash_attention` on the card that the backward
    kernels do not take: ``zero_empty_rows=False`` (no LM path asks for
    it)."""


# the widest head dim the backward kernels are built for (64, 128, 256)
GRAD_MAX_HEAD_DIM = 256
# the backward kernels' tiles (csrc/fk_attention_bwd.cu: kBlock, kRows,
# kTile): a dK / dV block's keys and a dQ block's query rows; a consumer
# warpgroup's share of them; a walk step's query rows (dK / dV) or keys
# (dQ). The producer skips a step by live_tiles at (BWD_TILE, BWD_BLOCK)
# (dK / dV) or (BWD_BLOCK, BWD_TILE) (dQ); a warpgroup skips or unmasks it
# by live_tiles at (BWD_TILE, BWD_ROWS) or (BWD_ROWS, BWD_TILE)
BWD_BLOCK, BWD_ROWS, BWD_TILE = 128, 64, 64
# at hd 256 (KvShape, QShape): a dK / dV block is BWD_ROWS keys whose dK and
# dV columns the two warpgroups split in halves of BWD_HALF_HD, and a dQ
# walk step is BWD_TILE_HD256 keys
BWD_HALF_HD, BWD_TILE_HD256 = 128, 32
# the f32 backward's tiles by head dim (csrc/fk_attention_bwd_f32.cu: Tile):
# (rows a block: keys for dK / dV, query rows for dQ; a walk step's query
# rows or keys)
BWD_F32_TILES = {64: (64, 64), 128: (64, 32), 256: (32, 32)}


def _padded_hd(hd: int) -> int:
    hdp = next((d for d in hw.FLASH_HEAD_DIMS if d >= hd), None)
    if hdp is None:
        raise ValueError(f"head dim {hd} > {hw.FLASH_HEAD_DIMS[-1]}, the "
                         f"widest the kernel is built for")
    return hdp


def _check_grad(q, hd: int, zero_empty_rows: bool) -> None:
    if not zero_empty_rows:
        raise FlashGradUnsupported(
            "flash_attention's backward kernels take zero_empty_rows=True "
            "(attend's contract)")


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with its gradient: the forward kernel with a
    row log-sum-exp output, the backward kernels of
    :func:`flash_attention_backward` (on CPU tensors both run their plain
    versions)."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window,
                zero_empty_rows):
        if _build.on_cpu(q, k, v, q_positions, kv_positions):
            out = flash_attention_plain(q, k, v, q_positions, kv_positions,
                                        causal=causal, window=window,
                                        zero_empty_rows=zero_empty_rows)
            lse = flash_lse_plain(q, k, q_positions, kv_positions,
                                  causal=causal, window=window)
        else:
            _check_grad(q, q.shape[3], zero_empty_rows)
            out, lse = _launch(q, k, v, q_positions, kv_positions, causal,
                               window, zero_empty_rows, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.opts = (causal, window, zero_empty_rows)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, qpos, kpos = ctx.saved_tensors
        causal, window, zero_empty_rows = ctx.opts
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, do, lse, qpos, kpos, causal=causal, window=window,
            zero_empty_rows=zero_empty_rows)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    zero_empty_rows: bool = False) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, KV, Skv, hd); positions absolute ints.

    Returns (B, H, Sq, hd) in q's dtype (f32, bf16 or fp16 on the
    card). A row
    with no valid key is the mean of v, or zero with ``zero_empty_rows``.
    The reference's ``block_q``/``block_k``/``interpret`` are TPU tiling
    controls; the kernels pick their tiles themselves (``hw.FLASH_*``).
    With grad mode on and q, k or v requiring grad the call goes through
    :class:`FlashAttentionFn`.
    """
    _check_shapes(q, k, v, q_positions, kv_positions, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_positions, kv_positions,
                                      causal, window, zero_empty_rows)
    if _build.on_cpu(q, k, v, q_positions, kv_positions):
        return flash_attention_plain(q, k, v, q_positions, kv_positions,
                                     causal=causal, window=window,
                                     zero_empty_rows=zero_empty_rows)
    return _launch(q, k, v, q_positions, kv_positions, causal, window,
                   zero_empty_rows)[0]


def _launch(q, k, v, q_positions, kv_positions, causal: bool, window: int,
            zero_empty_rows: bool, *, with_lse: bool = False):
    """The forward kernel on CUDA tensors: (out, lse or None)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share a dtype in float32/bfloat16/"
                         f"float16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if skv < 1:
        raise ValueError("flash_attention needs at least one key")
    hdp = _padded_hd(hd)
    if hdp != hd:
        q, k, v = (F.pad(t, (0, hdp - hd)) for t in (q, k, v))
    out = torch.empty((b, sq, h, hdp), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if sq == 0:
        return out[..., :hd], lse
    qpos = q_positions.to(torch.int32).contiguous()
    kpos = kv_positions.to(torch.int32).contiguous()
    strides = (_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
               + _strides(out, "out"))
    lib = _build.library("fk_attention").lib
    dev = q.device
    stream = _build.stream_of(q)
    name = kernel_for(sq, q.dtype, with_lse)
    part = tickets = None
    if name == "flash_decode_kernel":
        if dev.index != torch.cuda.current_device():
            raise RuntimeError(
                f"flash_attention: inputs on {dev}, current device "
                f"cuda:{torch.cuda.current_device()}; the decode kernel's "
                f"plan follows the current device")
        part, tickets = _decode_workspace(
            lib, dev, stream, (b, h, kvh, sq, skv, hdp, _DTYPES[q.dtype]))
    code = lib.fk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(), b, h, kvh, sq, skv, hdp, *strides,
        int(causal), int(window), int(zero_empty_rows), _DTYPES[q.dtype],
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        None if lse is None else lse.data_ptr(), stream)
    _build.check(code, "flash_attention", "fk_attention")
    flash_attention.launches += 1
    flash_attention.kernel_launches[name] += 1
    return (out if hdp == hd else out[..., :hd]), lse


flash_attention.launches = 0
flash_attention.kernel_launches = dict.fromkeys(
    ("flash_prefill_kernel", "flash_decode_kernel", "flash_f32_kernel"), 0)


def kernel_for(sq: int, dtype: torch.dtype, with_lse: bool = False) -> str:
    """The kernel the C entry point launches for Sq query rows of dtype
    (with an lse output, always the prefill kernel)."""
    if sq <= hw.FLASH_DECODE_MAX_SQ and not with_lse:
        return "flash_decode_kernel"
    if dtype == torch.float32:
        return "flash_f32_kernel"
    return "flash_prefill_kernel"


# the decode kernel's workspace sizes by (device, shape), and its partials
# and block tickets by (device, stream), grown on demand: launches on one
# stream run in order, so each finds the tickets zero (the last blocks of a
# launch reset theirs) and may overwrite the partials of the one before
_SIZES: dict[tuple, tuple[int, int]] = {}
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _decode_workspace(lib, dev: torch.device, stream: int,
                      shape: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's f32 partials and int tickets for this stream, at
    least ``fk_flash_workspace``'s sizes for ``shape``."""
    key = (dev.index, *shape)
    sizes = _SIZES.get(key)
    if sizes is None:
        got = (ctypes.c_longlong * 4)()
        _build.check(lib.fk_flash_workspace(*shape, ctypes.addressof(got)),
                     "flash_attention workspace", "fk_attention")
        sizes = _SIZES[key] = (int(got[0]), int(got[1]))
    part, tickets = _WORKSPACE.get((dev.index, stream), (None, None))
    if part is None or part.numel() < sizes[0]:
        part = torch.empty(sizes[0], dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < sizes[1]:
        tickets = torch.zeros(sizes[1], dtype=torch.int32, device=dev)
    _WORKSPACE[(dev.index, stream)] = (part, tickets)
    return part, tickets


def _addressable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can address it through its strides, else a
    contiguous copy."""
    try:
        _strides(t, "")
        return t
    except ValueError:
        return t.contiguous()


def _like_heads(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, N, S, hd) tensor stored as (B, S, N, hd), the layout
    ``attend``'s transposed views have."""
    b, n, s, d = t.shape
    return torch.empty((b, s, n, d), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def flash_attention_backward(q, k, v, out, do, lse, q_positions,
                             kv_positions, *, causal: bool = True,
                             window: int = 0, zero_empty_rows: bool = True):
    """(dq, dk, dv) of :func:`flash_attention` from its output ``out`` and
    row log-sum-exp ``lse`` (B, H, Sq) f32. On CPU tensors
    :func:`flash_attention_backward_plain`; on CUDA tensors the three
    kernels of ``csrc/fk_attention_bwd.cu`` at bf16 / fp16
    (:func:`flash_bwd_prep`, then :func:`flash_bwd_dkdv` and
    :func:`flash_bwd_dq`) or of ``csrc/fk_attention_bwd_f32.cu`` at f32
    (:func:`flash_bwd_f32_prep`, :func:`flash_bwd_f32_dkdv`,
    :func:`flash_bwd_f32_dq`), or :class:`FlashGradUnsupported` for what
    they do not take. Head dims other than 64, 128 and 256 are zero-padded
    (a copy), as the forward pads them."""
    _check_shapes(q, k, v, q_positions, kv_positions, window)
    if _build.on_cpu(q, k, v, out, do, lse, q_positions, kv_positions):
        return flash_attention_backward_plain(
            q, k, v, out, do, lse, q_positions, kv_positions, causal=causal,
            window=window, zero_empty_rows=zero_empty_rows)
    b, h, sq, hd = q.shape
    _check_grad(q, hd, zero_empty_rows)
    if not (q.dtype == k.dtype == v.dtype == out.dtype == do.dtype):
        raise ValueError(f"q, k, v, out and do must share a dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}, "
                         f"{do.dtype}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse must be f32 (B, H, Sq), got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    hdp = _padded_hd(hd)
    ops = [q, k, v, out, do]
    if hdp != hd:
        ops = [F.pad(t, (0, hdp - hd)) for t in ops]
    q, k, v, out, do = (_addressable(t) for t in ops)
    if sq == 0:
        return (_like_heads(q)[..., :hd], torch.zeros_like(k)[..., :hd],
                torch.zeros_like(v)[..., :hd])
    lse = lse.contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    kpos = kv_positions.to(torch.int32).contiguous()
    if q.dtype == torch.float32:
        dkdv, dq_fn = flash_bwd_f32_dkdv, flash_bwd_f32_dq
        dsum = flash_bwd_f32_prep(out, do)
    else:
        dkdv, dq_fn = flash_bwd_dkdv, flash_bwd_dq
        dsum = flash_bwd_prep(q, k, v, do, lse, qpos, kpos, causal=causal,
                              window=window)
    dk, dv = dkdv(q, k, v, do, lse, dsum, qpos, kpos, causal=causal,
                  window=window)
    dq = dq_fn(q, k, v, do, lse, dsum, qpos, kpos, causal=causal,
               window=window)
    if hdp != hd:
        return dq[..., :hd], dk[..., :hd], dv[..., :hd]
    return dq, dk, dv



def _stride_array(*tensors) -> ctypes.Array:
    flat = [x for t in tensors for x in _strides(t, "operand")]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_bwd_prep(q, k, v, do, lse, qpos, kpos, *, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    """``flash_bwd_prep_kernel``: D = rowsum(P o dP) in f32, (B, H, Sq)
    contiguous, P = exp(S - lse) on the valid pairs and dP = dO V^T, of the
    operands :func:`flash_bwd_dq` takes (the dQ kernel's walk with S and dP
    only). Plain version: :func:`flash_bwd_prep_plain`."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    st = _stride_array(q, k, v, do)
    lib = _build.library("fk_attention_bwd").lib
    _build.check(lib.fk_flash_bwd_prep(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
        b, h, kvh, sq, skv, hd, ctypes.addressof(st), int(causal),
        int(window), _DTYPES[q.dtype], _build.stream_of(q)),
        "flash_bwd_prep", "fk_attention_bwd")
    flash_bwd_prep.launches += 1
    flash_bwd_prep.launches_hd256 += hd == 256
    return dsum


def flash_bwd_dkdv(q, k, v, do, lse, dsum, qpos, kpos, *,
                   causal: bool = True, window: int = 0):
    """``flash_bwd_dkdv_kernel``: (dk, dv) of the operands
    :func:`flash_attention_backward` checked and made addressable, int32
    positions, f32 lse and D (B, H, Sq) contiguous; stored as (B, Skv, KV,
    hd) transposed views. Plain version: the dk and dv of
    :func:`flash_attention_backward_plain`."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dk, dv = _like_heads(k), _like_heads(v)
    st = _stride_array(q, k, v, do, dk, dv)
    lib = _build.library("fk_attention_bwd").lib
    _build.check(lib.fk_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq, skv, hd,
        ctypes.addressof(st), int(causal), int(window), _DTYPES[q.dtype],
        _build.stream_of(q)), "flash_bwd_dkdv", "fk_attention_bwd")
    flash_bwd_dkdv.launches += 1
    flash_bwd_dkdv.launches_hd256 += hd == 256
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, dsum, qpos, kpos, *, causal: bool = True,
                 window: int = 0) -> torch.Tensor:
    """``flash_bwd_dq_kernel``: dq of the same operands, stored as a (B,
    Sq, H, hd) transposed view. Plain version: the dq of
    :func:`flash_attention_backward_plain`."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dq = _like_heads(q)
    st = _stride_array(q, k, v, do, dq)
    lib = _build.library("fk_attention_bwd").lib
    _build.check(lib.fk_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
        dq.data_ptr(), b, h, kvh, sq, skv, hd, ctypes.addressof(st),
        int(causal), int(window), _DTYPES[q.dtype], _build.stream_of(q)),
        "flash_bwd_dq", "fk_attention_bwd")
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_hd256 += hd == 256
    return dq


flash_bwd_prep.launches = flash_bwd_prep.launches_hd256 = 0
flash_bwd_dkdv.launches = flash_bwd_dkdv.launches_hd256 = 0
flash_bwd_dq.launches = flash_bwd_dq.launches_hd256 = 0


def flash_bwd_f32_prep(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``flash_bwd_f32_prep_kernel``: D = rowsum(dO o O), (B, H, Sq), of two
    f32 CUDA tensors (B, H, Sq, hd) that the kernels can address (hd 64,
    128 or 256). Plain version: ``(do * out).sum(-1)``."""
    b, h, sq, hd = out.shape
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=out.device)
    st = _stride_array(out, do)
    lib = _build.library("fk_attention_bwd_f32").lib
    _build.check(lib.fk_flash_bwd_f32_prep(
        out.data_ptr(), do.data_ptr(), dsum.data_ptr(), b, h, sq, hd,
        ctypes.addressof(st), _build.stream_of(out)),
        "flash_bwd_f32_prep", "fk_attention_bwd_f32")
    flash_bwd_f32_prep.launches += 1
    return dsum


def flash_bwd_f32_dkdv(q, k, v, do, lse, dsum, qpos, kpos, *,
                       causal: bool = True, window: int = 0):
    """``flash_bwd_f32_dkdv_kernel``: (dk, dv) of f32 operands as
    :func:`flash_bwd_dkdv` takes them. Plain version: the dk and dv of
    :func:`flash_attention_backward_plain`."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dk, dv = _like_heads(k), _like_heads(v)
    st = _stride_array(q, k, v, do, dk, dv)
    lib = _build.library("fk_attention_bwd_f32").lib
    _build.check(lib.fk_flash_bwd_f32_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq, skv, hd,
        ctypes.addressof(st), int(causal), int(window), _build.stream_of(q)),
        "flash_bwd_f32_dkdv", "fk_attention_bwd_f32")
    flash_bwd_f32_dkdv.launches += 1
    return dk, dv


def flash_bwd_f32_dq(q, k, v, do, lse, dsum, qpos, kpos, *,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """``flash_bwd_f32_dq_kernel``: dq of the same f32 operands, stored as a
    (B, Sq, H, hd) transposed view. Plain version: the dq of
    :func:`flash_attention_backward_plain`."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dq = _like_heads(q)
    st = _stride_array(q, k, v, do, dq)
    lib = _build.library("fk_attention_bwd_f32").lib
    _build.check(lib.fk_flash_bwd_f32_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
        dq.data_ptr(), b, h, kvh, sq, skv, hd, ctypes.addressof(st),
        int(causal), int(window), _build.stream_of(q)),
        "flash_bwd_f32_dq", "fk_attention_bwd_f32")
    flash_bwd_f32_dq.launches += 1
    return dq


flash_bwd_f32_prep.launches = 0
flash_bwd_f32_dkdv.launches = 0
flash_bwd_f32_dq.launches = 0


def bwd_resources(kernel: str, dtype: torch.dtype, hd: int) -> dict:
    """``flash_bwd_dkdv_kernel`` or ``flash_bwd_dq_kernel`` (``kernel``:
    "dkdv" or "dq") at bf16 / fp16 and hd 64 / 128 / 256 on the card:
    resident blocks an SM, registers and local-memory (spill) bytes a
    thread as the runtime reports them, dynamic shared bytes, and the
    registers a thread of each role after ``setmaxnreg`` (producer,
    consumers); at f32 the f32 kernels' first four. Needs a CUDA card (the
    library's build)."""
    if dtype == torch.float32:
        out = (ctypes.c_int * 4)()
        _build.check(_build.library(
            "fk_attention_bwd_f32").lib.fk_flash_bwd_f32_resources(
                {"dkdv": 0, "dq": 1}[kernel], hd, out),
            "flash_bwd_f32 resources", "fk_attention_bwd_f32")
        return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                         "smem_bytes"), out))
    out = (ctypes.c_int * 6)()
    _build.check(_build.library("fk_attention_bwd").lib.fk_flash_bwd_resources(
        {"dkdv": 0, "dq": 1}[kernel], _DTYPES[dtype], hd, out),
        "flash_bwd resources", "fk_attention_bwd")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes", "producer_registers",
                     "consumer_registers"), out))
