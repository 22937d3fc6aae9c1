"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro.models.rglru``. Block = linear in-projection to width
W, short causal conv, the Real-Gated LRU recurrence, gated by a GeLU
branch, linear out-projection:

    r_t = sigmoid(w_a . x_t + b_a)          (recurrence gate, diagonal)
    i_t = sigmoid(w_i . x_t + b_i)          (input gate, diagonal)
    a_t = exp(-c * softplus(Lambda) * r_t)  (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

Prefill runs the recurrence as a log-depth doubling scan over the sequence
(:func:`_recurrence`, the reference's ``lax.associative_scan``); decode is
one elementwise update of the carried f32 state. The reference computes it
in XLA, not Pallas, so plain PyTorch is its counterpart.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.ft.abft_dense import ft_einsum
from repro_torch.models import layers as L

C_FACTOR = 8.0


class RGLRUCache(NamedTuple):
    h: torch.Tensor        # (B, W) f32 recurrent state
    conv: torch.Tensor     # (B, conv_width-1, W)


def init_cache(cfg, batch: int, dtype: torch.dtype,
               device=None) -> RGLRUCache:
    w = cfg.rglru_width or cfg.d_model
    return RGLRUCache(
        torch.zeros((batch, w), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                    device=device))


def init_rglru(gen: torch.Generator, cfg,
               dtype: torch.dtype) -> L.Tree:
    d = cfg.d_model
    w = cfg.rglru_width or d
    params = L.build(gen, {"in_x": ((d, w), ("embed", "mlp")),
                           "in_gate": ((d, w), ("embed", "mlp")),
                           "conv_w": ((cfg.conv_width, w), ("conv", None)),
                           "out": ((w, d), ("mlp", "embed"))}, dtype)
    for name in ("lambda_p", "w_a", "b_a", "w_i", "b_i"):
        params.add(name, torch.full((w,), 0.5 if name == "lambda_p" else 0.0,
                                    dtype=torch.float32, device=gen.device),
                   ("mlp",))
    return params


def _recurrence(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t for a, b (B, S, W), h_{-1} = h0 (or 0).

    A doubling (Hillis-Steele) scan: after the step of span d every t holds
    the composition of elements t-2d+1 .. t under the combine (a1, b1) then
    (a2, b2) -> (a1 a2, a2 b1 + b2); log2(S) steps on whole tensors. h0 is
    folded into b[:, 0] first, as the reference does."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s, d = a.shape[1], 1
    while d < s:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b


def apply_rglru(cfg, params: Mapping, u: torch.Tensor, *,
                cache: Optional[RGLRUCache] = None
                ) -> tuple[torch.Tensor, Optional[RGLRUCache]]:
    """u (B, S, D) -> (B, S, D), and the new cache when one is given. With
    a cache and S == 1: the decode update."""
    b, s, d = u.shape
    w = cfg.rglru_width or d
    x = ft_einsum("bsd,dw->bsw", u, params["in_x"])
    gate = L._act("gelu", ft_einsum("bsd,dw->bsw", u, params["in_gate"]))

    conv_w = params["conv_w"]
    width = conv_w.shape[0]
    pad = (x.new_zeros((b, width - 1, w)) if cache is None
           else cache.conv.to(x.dtype))
    full = torch.cat([pad, x], dim=1)
    x = full[:, 0:s] * conv_w[0]
    for i in range(1, width):
        x = x + full[:, i:i + s] * conv_w[i]
    new_conv = full[:, full.shape[1] - (width - 1):]

    xf = x.float()
    r = torch.sigmoid(params["w_a"] * xf + params["b_a"])
    i = torch.sigmoid(params["w_i"] * xf + params["b_i"])
    log_a = -C_FACTOR * F.softplus(params["lambda_p"]) * r       # (B,S,W)
    a = torch.exp(log_a)
    bterm = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)

    if s == 1 and cache is not None:                  # decode fast path
        h = a[:, 0] * cache.h + bterm[:, 0]
        hs = h[:, None]
    else:
        hs = _recurrence(a, bterm, None if cache is None else cache.h)
        h = hs[:, -1]

    y = hs.to(u.dtype) * gate
    out = ft_einsum("bsw,wd->bsd", y, params["out"])
    new_cache = RGLRUCache(h, new_conv) if cache is not None else None
    return out, new_cache


__all__ = ["RGLRUCache", "C_FACTOR", "apply_rglru", "init_cache",
           "init_rglru"]
