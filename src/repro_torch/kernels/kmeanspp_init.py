"""Fused k-means++ D^2 seeding for B stacked problems, one launch a round.

Replaces the Pallas TPU kernel ``kmeanspp_round`` of
``src/repro/kernels/kmeanspp_init.py`` (body ``_round_kernel``) and ports
the seeding loop around it (``_select_index``, ``_init_impl``,
``init_kmeanspp_fused``). One round over the (B, Np / bn) grid:

  * ``d2' = min(d2, max(xn - 2 <x, c_last> + ||c_last||^2, 0))`` against the
    centroid chosen last round;
  * one f32 sum of ``d2'`` per (problem, row tile): the first level of the
    inverse-CDF selection.

Selection stays plain tensor code, as in the reference: a cumulative sum
over the T tile sums picks the tile, a cumulative sum over that tile's bn
entries picks the row, one uniform draw per round, and no host read in the
loop. Padded rows carry d2 = 0 from the start: zero mass never advances the
CDF, so a padded row is never drawn.

CUDA kernel: ``kmeanspp_round_kernel`` in ``csrc/fk_kernels.cu``. One block
per (problem, row tile) stages 256 rows x 32 features of the tile in shared
memory with consecutive threads on consecutive floats, thread r dots row r
with the centroid row, and the tile sum runs in a fixed order (each
thread's rows, a warp butterfly, the 8 warp partials in order): no
atomics, so a round repeats bit for bit. Features are not padded: at
F = 16 padding to 32 would only double the bytes.

Bound on the H100: the bytes of X (B * Np * F * 4 read once per round;
201 MB at B = 48, N = 65,536, F = 16, 60 us at 3.35 TB/s); the GEMV's
2 * B * Np * F FLOPs are ~100x under the f32 peak.

Draws: ``jax.random`` cannot be reproduced, so problem b takes a CPU
``torch.Generator`` seeded ``random_state + b`` and draws, in the
reference's protocol, ``i0 = randint(n)`` and ``us = rand(K - 1)`` up front
(:func:`draws`). A problem's seeds then depend neither on B nor on the
device. :func:`seed_indices` is the draw-consuming core, so a test can feed
it the reference's own draws.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import hw
from repro_torch.kernels import _build, ref
from repro_torch.kernels.lloyd_step import MAX_PROBLEMS


def _round_up(v: int, b: int) -> int:
    return -(-v // b) * b


def clamp_init_block(n: int, block_n: int) -> int:
    """Row tile of the round: at least 128 and no larger than the 128-aligned
    problem (bigger only buys padding) -- the reference's rule, so both
    packages walk the same two-level CDF for the same ``block_n``."""
    return max(128, min(block_n, _round_up(n, 128)))


def _check_round(x, xn, c, d2, block_n: int) -> None:
    b, np_, f = x.shape
    if xn.shape != (b, np_) or d2.shape != (b, np_) or c.shape != (b, 1, f) \
            or b < 1 or block_n < 1 or np_ % block_n:
        raise ValueError(f"unpadded round inputs x {tuple(x.shape)}, xn "
                         f"{tuple(xn.shape)}, c {tuple(c.shape)}, d2 "
                         f"{tuple(d2.shape)} vs block_n={block_n}")
    if b > MAX_PROBLEMS:
        raise ValueError(f"{b} problems in one launch; the kernel's grid "
                         f"holds at most {MAX_PROBLEMS} (gridDim.y)")


def kmeanspp_round_plain(x: torch.Tensor, xn: torch.Tensor, c: torch.Tensor,
                         d2: torch.Tensor, block_n: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the reference's tile-mirrored twin
    (``_round_twin``): same cross-term form, same tile decomposition."""
    ref.full_f32(x.device)
    cross = torch.matmul(x, c.transpose(1, 2))[:, :, 0]          # (B, Np)
    cn = (c * c).sum(2)                                          # (B, 1)
    nd = torch.clamp_min(xn - 2.0 * cross + cn, 0.0)
    d2n = torch.minimum(d2, nd)
    b, np_ = d2n.shape
    return d2n, d2n.view(b, np_ // block_n, block_n).sum(2)


def kmeanspp_round(x: torch.Tensor, xn: torch.Tensor, c: torch.Tensor,
                   d2: torch.Tensor, *, block_n: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused D^2 round. x (B, Np, F) f32 row-padded samples, xn (B, Np)
    their squared norms, c (B, 1, F) the last-chosen centroid per problem,
    d2 (B, Np) the running minimum (0 in padded rows). Returns (d2' (B, Np),
    tile sums (B, Np / block_n))."""
    _check_round(x, xn, c, d2, block_n)
    if _build.on_cpu(x, xn, c, d2):
        return kmeanspp_round_plain(x, xn, c, d2, block_n)
    b, np_, f = x.shape
    d2o = torch.empty_like(d2)
    ts = torch.empty((b, np_ // block_n), dtype=torch.float32,
                     device=x.device)
    f32 = torch.float32
    code = _build.library().lib.fk_kmeanspp_round(
        _build.ptr(x, f32, "x"), _build.ptr(xn, f32, "xn"),
        _build.ptr(c, f32, "c"), _build.ptr(d2, f32, "d2"), d2o.data_ptr(),
        ts.data_ptr(), b, np_, f, block_n, _build.stream_of(x))
    _build.check(code, "kmeanspp_round")
    kmeanspp_round.launches += 1
    return d2o, ts


kmeanspp_round.launches = 0


def select_index(d2: torch.Tensor, ts: torch.Tensor, u: torch.Tensor,
                 block_n: int, n: int) -> torch.Tensor:
    """Two-level inverse CDF (the reference's ``_select_index``): the tile
    from the T partial sums, the row offset from the chosen tile's bn
    entries. One uniform per problem; zero-mass rows never advance the CDF.
    Returns (B,) int64 row indices."""
    if ts.shape[1] == 1:
        # single tile: the inner cumsum is the whole CDF
        inner = torch.cumsum(d2, 1)
        off = (inner <= (u * inner[:, -1])[:, None]).sum(1)
        return off.clamp_max(n - 1)
    b, t = ts.shape
    cum = torch.cumsum(ts, 1)                                    # (B, T)
    target = u * cum[:, -1]
    tile = (cum <= target[:, None]).sum(1).clamp_max(t - 1)
    prev = torch.where(tile > 0,
                       cum.gather(1, (tile - 1).clamp_min(0)[:, None])[:, 0],
                       0.0)
    d2t = d2.view(b, t, block_n).gather(
        1, tile[:, None, None].expand(b, 1, block_n))[:, 0]       # (B, bn)
    inner = torch.cumsum(d2t, 1)
    off = (inner <= (target - prev)[:, None]).sum(1).clamp_max(block_n - 1)
    return (tile * block_n + off).clamp_max(n - 1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every problem: (B, 1, F)."""
    return x.gather(1, idx[:, None, None].expand(x.shape[0], 1, x.shape[2]))


def seed_indices(x: torch.Tensor, i0: torch.Tensor, us: torch.Tensor, k: int,
                 block_n: int) -> torch.Tensor:
    """The draw-consuming core: x (B, N, F), first rows i0 (B,), round
    uniforms us (B, K-1) -> chosen row indices (B, K) int64. Runs K - 1
    rounds and never reads the device from the host."""
    b, n, _ = x.shape
    np_ = _round_up(n, block_n)
    xp = x.float()
    if np_ != n:
        xp = F.pad(xp, (0, 0, 0, np_ - n))
    xp = xp.contiguous()
    xn = (xp * xp).sum(2)
    d2 = torch.where(torch.arange(np_, device=x.device) < n, torch.inf,
                     0.0).expand(b, np_).contiguous()
    i0 = i0.to(device=x.device, dtype=torch.int64)
    us = us.to(device=x.device, dtype=torch.float32)
    idx = torch.zeros((b, k), dtype=torch.int64, device=x.device)
    idx[:, 0] = i0
    last = _rows(xp, i0)
    for i in range(1, k):
        d2, ts = kmeanspp_round(xp, xn, last, d2, block_n=block_n)
        sel = select_index(d2, ts, us[:, i - 1], block_n, n)
        idx[:, i] = sel
        last = _rows(xp, sel)
    return idx


def draws(n: int, k: int, seeds: Sequence[int]
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-problem draws on the CPU, in the reference's protocol: problem b's
    generator, seeded ``seeds[b]``, draws the first row, then the K - 1
    round uniforms. Returns (i0 (B,) int64, us (B, K-1) f32)."""
    i0, us = [], []
    for s in seeds:
        gen = torch.Generator().manual_seed(int(s))
        i0.append(torch.randint(n, (1,), generator=gen))
        us.append(torch.rand(k - 1, generator=gen))
    return torch.cat(i0), torch.stack(us)


def init_kmeanspp_fused(x: torch.Tensor, k: int, seeds: Sequence[int], *,
                        block_n: Optional[int] = None) -> torch.Tensor:
    """Fused k-means++ seeding of B stacked problems x (B, N, F): problem b
    draws from ``seeds[b]``. Returns (B, K, F) rows of x."""
    b, n, _ = x.shape
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for {b} problems")
    block_n = clamp_init_block(n, block_n or hw.INIT_BLOCK_N)
    i0, us = draws(n, k, seeds)
    idx = seed_indices(x, i0, us, k, block_n)
    return x.gather(1, idx[..., None].expand(b, k, x.shape[2]))
