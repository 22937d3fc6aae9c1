"""ABFT-protected projections for the LM stack (the paper's technique).

The port of ``repro.ft.abft_dense``: ``ft_einsum`` is the one entry point
the model layers use for every dense contraction. With FT disabled it is
``torch.einsum``; with FT enabled the main product runs untouched and the
paper's dual-checksum invariant is checked by separate vector contractions
over the flattened token dimensions:

    exp1 = (sum_tokens x) @ W          obs1 = sum_tokens D      (out...,)
    exp2 = (sum_tokens w_t * x) @ W    obs2 = sum_tokens w_t*D  w_t = 1..T

detection: |obs1 - exp1| > threshold at output coordinate j;
location:  flat token index t = round((obs2-exp2)_j / (obs1-exp1)_j) - 1;
correction: D[t, j] -= delta (at most one upset per product).

:func:`detect_correct` is that step on a finished product ``d``, so a test
can corrupt ``d`` first. With FT enabled and autograd recording, the
protected product is :class:`_Protected`, the reference's ``custom_vjp``:
its forward is the einsum and the check, with no graph through the
checksums; its backward is the reference's ``_bwd``, the two plain
einsums of the gradient cast to the inputs' dtypes (a correction is a
constant shift of one output element, so it has no gradient of its own).
Everything stays on the device: no host read decides a correction.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.distributed.tensor import DTensor


class FTContext(threading.local):
    """Per-thread FT switches; configured once by the step builder."""

    def __init__(self):
        self.enabled = False

    def configure(self, enabled: bool):
        self.enabled = enabled


_CTX = FTContext()


def configure(enabled: bool):
    _CTX.configure(enabled)


def ft_enabled() -> bool:
    return _CTX.enabled


@contextlib.contextmanager
def enabled_as(enabled: bool):
    """This thread's switch set to ``enabled`` for the block, then restored
    (autograd recomputes a checkpointed block on its own device thread,
    which must see the switch the forward saw)."""
    before = _CTX.enabled
    _CTX.enabled = enabled
    try:
        yield
    finally:
        _CTX.enabled = before


def _parse(spec: str, x, w):
    """Returns (batch_labels, contracted, out_labels) or None."""
    try:
        lhs, out = spec.split("->")
        a, b = lhs.split(",")
    except ValueError:
        return None
    contracted = [c for c in a if c in b and c not in out]
    if not contracted or any(c in out for c in contracted):
        return None
    if a[-len(contracted):] != "".join(contracted) or \
            b[: len(contracted)] != "".join(contracted):
        return None
    batch_labels = a[: -len(contracted)]
    out_labels = b[len(contracted):]
    if out != batch_labels + out_labels:
        return None
    return batch_labels, contracted, out_labels


def detect_correct(spec: str, x: torch.Tensor, w: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """Check the product ``d = einsum(spec, x, w)`` against the checksums of
    ``x`` and ``w`` and correct one located element, as the reference's
    ``_detect_correct`` does. ``spec`` must be a projection form that
    :func:`_parse` accepts. Returns the corrected product (a new tensor)."""
    parsed = _parse(spec, x, w)
    if parsed is None:
        raise ValueError(f"{spec!r} is not a projection einsum")
    batch_labels, contracted, out_labels = parsed
    nb, nk = len(batch_labels), len(contracted)
    bdims = tuple(range(nb))
    k = 1
    for s in x.shape[nb:]:
        k *= s
    ntok = 1
    for s in x.shape[:nb]:
        ntok *= s
    out_elems = 1
    for s in w.shape[nk:]:
        out_elems *= s

    f32 = torch.float32
    xf = x.to(f32)
    df = d.to(f32)
    w2 = w.reshape(k, out_elems).to(f32)
    w_t = (torch.arange(ntok, dtype=f32, device=x.device) + 1.0).reshape(
        tuple(x.shape[:nb]) + (1,) * nk)
    exp1 = xf.sum(dim=bdims).reshape(k) @ w2                    # (out,)
    exp2 = (xf * w_t).sum(dim=bdims).reshape(k) @ w2
    obs1 = df.sum(dim=bdims).reshape(out_elems)
    w_t_out = w_t.reshape(tuple(x.shape[:nb]) + (1,) * len(out_labels))
    obs2 = (df * w_t_out).sum(dim=bdims).reshape(out_elems)

    res1 = obs1 - exp1
    res2 = obs2 - exp2
    eps = 1.1920929e-07
    scale = torch.clamp(exp1.abs().max() / ntok, min=1.0)
    thr = 16.0 * torch.sqrt(torch.tensor(float(k), dtype=f32)) * eps \
        * scale * ntok
    detected = (res1.abs() > thr).any()

    j = torch.argmax(res1.abs())
    delta = res1[j]
    safe = torch.where(delta == 0.0, torch.ones_like(delta), delta)
    t = torch.clamp((torch.round(res2[j] / safe) - 1.0).to(torch.int64),
                    0, ntok - 1)
    fix = torch.where(detected, delta, torch.zeros_like(delta)).to(d.dtype)
    out = d.contiguous().clone()
    out.view(-1).index_add_(0, (t * out_elems + j).reshape(1),
                            -fix.reshape(1))
    return out


class _Protected(torch.autograd.Function):
    """``detect_correct(einsum(spec, x, w))`` with the reference's backward
    (``src/repro/ft/abft_dense.py`` ``_bwd``): gx = g . w over the output
    labels, gw = x . g over the batch labels, each cast to its input's
    dtype."""

    @staticmethod
    def forward(ctx, spec, parsed, x, w):
        ctx.save_for_backward(x, w)
        ctx.spec_parts = parsed
        return detect_correct(spec, x, w, torch.einsum(spec, x, w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        batch_labels, contracted, out_labels = ctx.spec_parts
        k, o = "".join(contracted), "".join(out_labels)
        gx = torch.einsum(f"{batch_labels}{o},{k}{o}->{batch_labels}{k}",
                          g, w)
        gw = torch.einsum(f"{batch_labels}{k},{batch_labels}{o}->{k}{o}",
                          x, g)
        return None, None, gx.to(x.dtype), gw.to(w.dtype)


def ft_einsum(spec: str, x: torch.Tensor, w: torch.Tensor, *,
              enabled: Optional[bool] = None) -> torch.Tensor:
    """einsum with optional einsum-native ABFT protection.

    Supported specs are the LM stack's projection forms -- (batch..., k...)
    x (k..., out...). Other specs run as plain einsum. ``DTensor`` operands
    (a mesh) run ``repro_torch.dist.sharding.contract``, without ABFT.
    """
    on = _CTX.enabled if enabled is None else enabled
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        parsed = _parse(spec, x, w)
        if on or parsed is None:
            raise NotImplementedError(
                f"ft_einsum {spec!r} on DTensors: only the LM projections "
                f"without ABFT run on a mesh")
        from repro_torch.dist.sharding import contract
        return contract(spec, x, w, parsed)
    parsed = _parse(spec, x, w) if on else None
    if parsed is None:
        return torch.einsum(spec, x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Protected.apply(spec, parsed, x, w)
    return detect_correct(spec, x, w, torch.einsum(spec, x, w))
