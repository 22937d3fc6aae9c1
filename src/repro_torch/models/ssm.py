"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

The port of ``repro.models.ssm``. Prefill runs the chunked SSD scan: the
sequence is padded to a multiple of ``SSD_CHUNK`` and cut into chunks;
within a chunk the dual (attention-like) quadratic form is a few dense
products, between chunks a (B, H, P, N) f32 state is carried (a loop over
the chunks, the reference's ``lax.scan``). Decode (one token) updates the
same state: O(1) a token. The reference computes all of it in XLA, not
Pallas, so plain PyTorch is its counterpart.

Layout: inner = expand * d_model, P = head dim, H = inner / P heads, one
B / C group, state size N = cfg.ssm_state. ``A_log``, ``D`` and
``dt_bias`` are f32 parameters.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.ft.abft_dense import ft_einsum
from repro_torch.models import layers as L

SSD_CHUNK = 256
P_HEAD = 64


class SSMCache(NamedTuple):
    state: torch.Tensor    # (B, H, P, N) f32
    conv: torch.Tensor     # (B, W-1, conv_dim) trailing conv window


def dims(cfg) -> tuple[int, int, int, int]:
    """(inner, heads, head dim, state size)."""
    inner = cfg.ssm_expand * cfg.d_model
    nheads = cfg.ssm_heads or inner // P_HEAD
    return inner, nheads, inner // nheads, cfg.ssm_state


def init_cache(cfg, batch: int, dtype: torch.dtype, device=None) -> SSMCache:
    inner, h, p, n = dims(cfg)
    return SSMCache(
        torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.conv_width - 1, inner + 2 * n), dtype=dtype,
                    device=device))


def init_ssm(gen: torch.Generator, cfg,
             dtype: torch.dtype) -> L.Tree:
    d = cfg.d_model
    inner, h, p, n = dims(cfg)
    dev = gen.device
    params = L.build(gen, {
        # z (gate), x, B, C, dt packed in one input projection
        "in_proj": ((d, 2 * inner + 2 * n + h), ("embed", "mlp")),
        "conv_w": ((cfg.conv_width, inner + 2 * n), ("conv", None)),
        "out_proj": ((inner, d), ("mlp", "embed"))}, dtype)
    params.add("A_log", torch.zeros((h,), dtype=torch.float32, device=dev),
               (None,))
    params.add("D", torch.ones((h,), dtype=torch.float32, device=dev),
               (None,))
    params.add("dt_bias", torch.zeros((h,), dtype=torch.float32,
                                      device=dev), (None,))
    params["norm"] = L.init_rmsnorm(inner, dtype, dev)
    return params


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv then SiLU. u (B, S, C), w (W, C), carry
    (B, W-1, C) or None. Returns (out, the new carry)."""
    width = w.shape[0]
    if carry is None:
        pad = u.new_zeros((u.shape[0], width - 1, u.shape[2]))
    else:
        pad = carry.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    out = full[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + full[:, i:i + s] * w[i]
    new_carry = full[:, full.shape[1] - (width - 1):] if width > 1 else pad
    return F.silu(out), new_carry


def _split(cfg, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) from the packed input projection."""
    inner, h, p, n = dims(cfg)
    return torch.split(zxbcdt, [inner, inner, n, n, h], dim=-1)


def _ssd_chunk(state: torch.Tensor, chunk, *, A: torch.Tensor):
    """One chunk of the SSD scan. state (B, H, P, N) f32; chunk = (x (B, L,
    H, P), B, C (B, L, N), dt (B, L, H) f32). Returns (the chunk-exit
    state, y (B, L, H, P) f32)."""
    x, bm, cm, dt = chunk
    xf, bf, cf = x.float(), bm.float(), cm.float()
    dA = dt * A[None, None, :]                         # (B,L,H) negative
    cs = torch.cumsum(dA, dim=1)                       # (B,L,H)
    # intra-chunk: M[t,s] = C_t.B_s * exp(cs_t - cs_s) * dt_s   (s <= t).
    # The exponent is masked before exp (the reference masks the product
    # after it): for s > t, cs_t - cs_s > 0 can pass f32's range over a
    # chunk, and exp's inf times where's zero gradient is NaN in the
    # backward (mamba2-1.3b at 4096 tokens). The kept entries are the same
    # exp of the same value.
    scores = torch.einsum("bln,bsn->bls", cf, bf)
    n = x.shape[1]
    tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    seg = torch.where(tri[None, :, :, None],
                      cs[:, :, None, :] - cs[:, None, :, :],
                      torch.full((), -torch.inf, dtype=cs.dtype,
                                 device=x.device))          # (B,L,S,H)
    decay = torch.exp(seg)
    m = torch.where(tri[None, :, :, None], scores[..., None] * decay,
                    torch.zeros((), dtype=decay.dtype, device=x.device))
    y_diag = torch.einsum("blsh,bsh,bshp->blhp", m, dt, xf)
    # the incoming state's contribution
    y_off = torch.einsum("bln,bhpn,blh->blhp", cf, state, torch.exp(cs))
    # the chunk-exit state
    out_decay = torch.exp(cs[:, -1:, :] - cs)          # (B,L,H)
    new_state = state * torch.exp(cs[:, -1])[:, :, None, None] + \
        torch.einsum("blh,blh,bln,blhp->bhpn", out_decay, dt, bf, xf)
    return new_state, y_diag + y_off


def apply_ssm(cfg, params: Mapping, u: torch.Tensor, *,
              cache: Optional[SSMCache] = None, chunk: int = SSD_CHUNK
              ) -> tuple[torch.Tensor, Optional[SSMCache]]:
    """u (B, S, D) -> (B, S, D), and the new cache when one is given. With
    a cache and S == 1: the decode update."""
    b, s, _ = u.shape
    inner, h, p, n = dims(cfg)
    zxbcdt = ft_einsum("bsd,df->bsf", u, params["in_proj"])
    z, xbc_x, bmat, cmat, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xbc_x, bmat, cmat], dim=-1)
    conv_out, conv_carry = _causal_conv(
        conv_in, params["conv_w"], carry=None if cache is None else cache.conv)
    x, bmat, cmat = torch.split(conv_out, [inner, n, n], dim=-1)

    A = -torch.exp(params["A_log"])                    # (H,) negative decay
    dt_ = F.softplus(dt.float() + params["dt_bias"][None, None])  # (B,S,H)
    xh = x.reshape(b, s, h, p)
    state0 = (torch.zeros((b, h, p, n), dtype=torch.float32, device=u.device)
              if cache is None else cache.state)

    if s == 1:                                         # decode fast path
        dA = torch.exp(dt_[:, 0] * A[None])            # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt_[:, 0], bmat[:, 0].float(),
                           xh[:, 0].float())
        state = state0 * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), state)
        y = y.reshape(b, 1, h, p)
    else:
        pad = (-s) % chunk
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bp, cp, dtp = (F.pad(t, (0, 0, 0, pad)) for t in (bmat, cmat, dt_))
        state, ys = state0, []
        for c0 in range(0, s + pad, chunk):
            state, y_c = _ssd_chunk(
                state, (xp[:, c0:c0 + chunk], bp[:, c0:c0 + chunk],
                        cp[:, c0:c0 + chunk], dtp[:, c0:c0 + chunk]), A=A)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)[:, :s]

    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, inner).to(u.dtype)
    y = L.rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = ft_einsum("bsf,fd->bsd", y, params["out_proj"])
    new_cache = SSMCache(state, conv_carry) if cache is not None else None
    return out, new_cache


__all__ = ["SSMCache", "SSD_CHUNK", "apply_ssm", "dims", "init_cache",
           "init_ssm"]
