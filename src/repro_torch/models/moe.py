"""Mixture-of-Experts layer (GShard-style einsum dispatch).

The port of ``repro.models.moe``. Top-k routing with per-row capacity:
tokens beyond an expert's capacity are dropped (GShard / Switch semantics;
the residual stream carries them), the same tokens as in the reference:
the queue position of a (token, slot) is the cumulative count of its
expert over (S, K) in row-major order. The router product is in f32 (its
operands upcast, the reference's ``preferred_element_type``); the dispatch
and combine masks are in the activations' dtype; the expert products route
through ``ft_einsum``.

The one-hot einsum dispatch costs O(B S E C D), as in the reference; it is
XLA code there, not a Pallas kernel, so plain PyTorch is its counterpart.
One device, no mesh: the reference's expert parallelism has no counterpart.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.ft.abft_dense import ft_einsum
from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, cfg,
             dtype: torch.dtype) -> L.Tree:
    """Router (D, E), expert weights ``wi`` / ``wg`` (E, D, F) (``wg`` when
    the activation is gated) and ``wo`` (E, F, D), and the ``shared`` MLP
    when ``cfg.moe.shared_expert``."""
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.num_experts
    specs = {"router": ((d, e), ("embed", "experts")),
             "wi": ((e, d, f), ("experts", "embed", "expert_mlp")),
             "wo": ((e, f, d), ("experts", "expert_mlp", "embed"))}
    if L.mlp_gated(cfg.mlp_act):
        specs["wg"] = ((e, d, f), ("experts", "embed", "expert_mlp"))
    params = L.build(gen, specs, dtype)
    if cfg.moe.shared_expert:
        params["shared"] = L.init_mlp(gen, d, f, cfg.mlp_act, dtype)
    return params


def _capacity(s: int, k: int, e: int, factor: float) -> int:
    c = int(s * k / e * factor) + 1
    return max(min(c, s), 4)


def route(cfg, params: Mapping, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The router: (probs (B, S, E) f32, the top-k experts (B, S, K))."""
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    return probs, torch.topk(probs, cfg.moe.top_k, dim=-1)[1]


def apply_moe(cfg, params: Mapping, x: torch.Tensor, *,
              gate_idx: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux) with aux the GShard load-balancing
    loss E * sum_e f_e p_e / k (f32 scalar).

    ``gate_idx`` (B, S, K), when given, replaces the router's top-k
    choices (the gates are still this call's probabilities at those
    experts, renormalised): top-k is discontinuous, so two computations of
    one model that must agree up to rounding (two attention routes, decode
    against forward) are held to each other at the same choices."""
    b, s, _ = x.shape
    e = cfg.moe.num_experts
    k = cfg.moe.top_k
    c = _capacity(s, k, e, cfg.moe.capacity_factor)

    probs, top = route(cfg, params, x)                          # (B,S,E)
    gate_idx = top if gate_idx is None else gate_idx           # (B,S,K)
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # one-hot expert choice per (token, slot) (B, S, K, E), and its place in
    # the expert's queue: the cumulative count row-major over (S, K)
    choice = F.one_hot(gate_idx, e).float()
    flat = choice.reshape(b, s * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    choice = choice * (pos_in_expert < c)

    slot = F.one_hot((pos_in_expert * choice).sum(-1).long(), c).to(x.dtype)
    choice_lp = choice.to(x.dtype)
    dispatch = torch.einsum("bske,bskc->bsec", choice_lp, slot)
    combine = torch.einsum("bske,bskc,bsk->bsec", choice_lp, slot,
                           gate_vals.to(x.dtype))

    xin = torch.einsum("bsec,bsd->becd", dispatch, x)
    h = ft_einsum("becd,edf->becf", xin, params["wi"])
    if "wg" in params:
        h = L._act(cfg.mlp_act, ft_einsum("becd,edf->becf", xin,
                                          params["wg"])) * h
    else:
        h = L._act("relu2" if cfg.mlp_act == "relu2" else "gelu", h)
    out_e = ft_einsum("becf,efd->becd", h, params["wo"])
    y = torch.einsum("bsec,becd->bsd", combine, out_e)

    if cfg.moe.shared_expert:
        y = y + L.apply_mlp(params["shared"], x, cfg.mlp_act)

    frac_tokens = choice.sum(dim=2).mean(dim=(0, 1))             # (E,)
    mean_prob = probs.mean(dim=(0, 1))                           # (E,)
    aux = e * torch.sum(frac_tokens * mean_prob) / k
    return y, aux


__all__ = ["init_moe", "apply_moe", "route"]
