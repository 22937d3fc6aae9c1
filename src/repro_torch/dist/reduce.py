"""The checked, hierarchical centroid-update reduce over process groups
(counterpart of ``repro.dist.reduce``).

A Lloyd step's per-cluster ``(sums, counts)`` cross the mesh in at most two
hops: an exact sum over the intra-host axes (``row``, and ``problem`` of
size 1), then one hop over ``host`` that may carry the sums as blockwise
int8 with an error-feedback residual (``ReducePlan.compressed()``). Counts
always reduce exactly; only the sums take the int8 hop. A checked reduce
sums each contribution's update checksums beside it (they are linear, so
the checksum of a sum is the sum of the checksums) and re-verifies after
each hop, on the *dequantised* values of the compressed hop; a hop that
fails adds one detection.

A hop is one ``all_reduce`` of one flat f32 buffer: the sums, the counts,
the expected checksums and any ``extra`` values (the step's inertia and
detections) packed together, so a step costs at most two collectives.
:func:`psum` is the one collective of the module; gloo and NCCL both take
the tensor where it lies, on the host or on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core.checksum import threshold_factor
from repro_torch.dist.compression import dequantize, quantize

CROSS_HOST = ("exact", "int8")


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """How each Lloyd step's ``(sums, counts)`` cross the mesh:
    ``hierarchical`` splits the reduce into an intra-host and a cross-host
    hop where the mesh has a ``host`` axis of size > 1; ``cross_host``
    ("exact" or "int8") is the cross-host hop's transport of the sums."""

    hierarchical: bool = True
    cross_host: str = "exact"

    def __post_init__(self) -> None:
        if self.cross_host not in CROSS_HOST:
            raise ValueError(f"ReducePlan.cross_host must be one of "
                             f"{CROSS_HOST}, got {self.cross_host!r}")

    @classmethod
    def flat(cls) -> "ReducePlan":
        """One flat sum over every data axis."""
        return cls(hierarchical=False)

    @classmethod
    def compressed(cls, *, exact: bool = False) -> "ReducePlan":
        """The int8 error-feedback cross-host hop; ``exact=True`` keeps the
        two hops without quantisation (bit for bit the default plan)."""
        return cls(hierarchical=True,
                   cross_host="exact" if exact else "int8")


def hop_axes(mesh, reduce_axes: tuple,
             plan: ReducePlan) -> tuple[tuple, Optional[str]]:
    """Split the reduce axes into ``(intra, cross)``: ``host`` is the cross
    hop when the plan is hierarchical and the axis has size > 1; a flat
    plan, or a mesh without hosts, reduces in one hop (``cross`` None)."""
    if plan.hierarchical and "host" in reduce_axes \
            and mesh.shape["host"] > 1:
        return tuple(a for a in reduce_axes if a != "host"), "host"
    return tuple(reduce_axes), None


def psum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over ``group`` (``None``: this rank alone), as a new
    tensor on ``t``'s device, the same on every member."""
    if group is None:
        return t.clone()
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def update_checksums(sums: torch.Tensor, cnt: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dual linear checksums of one ``(sums, counts)`` contribution: the
    column sum over K and the sum weighted by ``w_k = 1..K``."""
    k = sums.shape[-2]
    w_k = torch.arange(1.0, k + 1.0, dtype=torch.float32, device=sums.device)
    return (torch.stack([sums.sum(-2), w_k @ sums], -2),
            torch.stack([cnt.sum(-1), cnt @ w_k], -1))


def checksums_mismatch(sums: torch.Tensor, cnt: torch.Tensor,
                       exp: torch.Tensor, cexp: torch.Tensor,
                       m_total: int) -> torch.Tensor:
    """True where reduced ``(sums, counts)`` disagree with the reduced
    expected checksums past the f32 rounding floor of an ``m_total``-row
    sum; each checksum row against its own clean magnitude, as the
    reference's. A leading problem axis gives one verdict a problem."""
    factor = threshold_factor(m_total, torch.float32)
    got, cgot = update_checksums(sums, cnt)
    thr1 = factor * exp[..., 0, :].abs().amax(-1).clamp_min(1.0)
    thr2 = factor * exp[..., 1, :].abs().amax(-1).clamp_min(1.0)
    return (((got[..., 0, :] - exp[..., 0, :]).abs() > thr1[..., None]
             ).any(-1)
            | ((got[..., 1, :] - exp[..., 1, :]).abs() > thr2[..., None]
               ).any(-1)
            | ((cgot[..., 0] - cexp[..., 0]).abs()
               > factor * cexp[..., 0].clamp_min(1.0))
            | ((cgot[..., 1] - cexp[..., 1]).abs()
               > factor * cexp[..., 1].clamp_min(1.0)))


def _hop(sums: torch.Tensor, cnt: torch.Tensor, extra: torch.Tensor,
         group: Any, checked: bool, m_total: int) -> tuple:
    """One hop: every part summed in one collective, then (checked) the
    reduced values re-verified against the reduced expectations."""
    parts = [sums, cnt, extra]
    if checked:
        parts.extend(update_checksums(sums, cnt))
    sizes = [p.numel() for p in parts]
    flat = psum(torch.cat([p.reshape(-1).float() for p in parts]), group)
    out = [f.reshape(p.shape) for f, p in zip(flat.split(sizes), parts)]
    bad = torch.zeros((), dtype=torch.int32, device=sums.device)
    if checked:
        bad = checksums_mismatch(out[0], out[1], out[3], out[4],
                                 m_total).sum().to(torch.int32)
    return out[0], out[1], out[2], bad


def reduce_update(sums: torch.Tensor, cnt: torch.Tensor, *, intra: Any,
                  cross: Any, compress: bool = False,
                  residual: Optional[torch.Tensor] = None,
                  checked: bool = False, m_total: int = 0,
                  extra: Optional[torch.Tensor] = None) -> tuple:
    """Reduce one step's ``(sums, counts)`` over the intra-host group, then
    the cross-host group (each a process group or ``None``; a ``None`` hop
    is skipped).

    Returns ``(sums, counts, bad_hops, residual_out, extra)``: ``bad_hops``
    counts the hops whose re-verification failed (0 unless ``checked``),
    ``residual_out`` is the next step's error-feedback carry (None unless
    ``compress``), ``extra`` the f32 values given (the step's inertia and
    detections) summed over both hops. The compressed hop quantises ``sums
    + residual`` (the intra hop made it the same on every member of the
    host group) and sums the dequantised values, the numerics of an int8
    transport with a local dequantise-and-accumulate.
    """
    dev = sums.device
    extra = torch.zeros(0, device=dev) if extra is None else extra
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    if intra is not None:
        sums, cnt, extra, b = _hop(sums, cnt, extra, intra, checked, m_total)
        bad = bad + b
    if cross is not None:
        if compress:
            carried = sums if residual is None else sums + residual
            q, scale = quantize(carried)
            sums = dequantize(q, scale, carried.shape[-1])
            residual = carried - sums
        sums, cnt, extra, b = _hop(sums, cnt, extra, cross, checked, m_total)
        bad = bad + b
    return sums, cnt, bad, residual, extra
