"""Shared LM building blocks: seeded parameters, norms, MLPs, RoPE, embedding.

The port of ``repro.models.layers``. Every ``init_*`` returns a
:class:`Tree`: a dict of tensors drawn from an explicit ``torch.Generator``
whose ``axes`` hold each tensor's logical axis names (the reference's
second, mirrored tree; ``repro_torch.dist.sharding`` maps them onto a
mesh). The axes ride beside the tensors, so the draws are the same with or
without a mesh. Every ``apply_*`` is a plain function of a params mapping.
Dense contractions route through ``repro_torch.ft.abft_dense.ft_einsum``,
so the paper's ABFT protection is a config switch, not a code change.

Where bf16 rounds matters on the card: the logits contract in f32 (the
reference's ``preferred_element_type=float32``), and a scalar that the
reference multiplies in the working dtype is rounded to it first.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import (constrain, contract, fsdp_hint,
                                      lookup)
from repro_torch.ft.abft_dense import ft_einsum


# ---------------------------------------------------------------------------
# Param construction
# ---------------------------------------------------------------------------

class Tree(dict):
    """A dict of parameters (or of sub-``Tree``s) with ``axes``: {name:
    logical axis names} for each tensor entry."""

    def __init__(self, params: Optional[dict] = None,
                 axes: Optional[dict] = None):
        super().__init__(params or {})
        self.axes = dict(axes or {})

    def add(self, name: str, value, axes: Optional[tuple] = None) -> None:
        self[name] = value
        if axes is not None:
            self.axes[name] = tuple(axes)


class MetaGenerator:
    """Stands for a generator on the ``meta`` device (torch has none):
    parameters drawn from it are shapes only, for placements at any
    size."""
    device = torch.device("meta")


def param(gen: torch.Generator, shape: tuple, dtype: torch.dtype, *,
          scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale) weight, drawn in f32 on the generator's device and
    cast to ``dtype``; ``scale`` defaults to 1/sqrt(fan_in)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if scale is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(dtype)


def build(gen: torch.Generator, specs: dict, dtype: torch.dtype) -> Tree:
    """specs: {name: (shape, axes)} or {name: (shape, axes, scale)}; drawn
    in order. Each entry's axes are ``fsdp_hint``-promoted when it is
    large."""
    params = Tree()
    for name, spec in specs.items():
        shape, axes = tuple(spec[0]), spec[1]
        scale = spec[2] if len(spec) > 2 else None
        params.add(name, param(gen, shape, dtype, scale=scale),
                   fsdp_hint(shape, axes))
    return params


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device) -> Tree:
    return Tree({"scale": torch.ones((d,), dtype=dtype, device=device)},
                {"scale": ("embed",)})


def rmsnorm(params: Mapping, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# MLPs (gated silu/gelu; ungated squared-ReLU for nemotron-4)
# ---------------------------------------------------------------------------

def mlp_gated(act: str) -> bool:
    return act in ("silu", "gelu")


def init_mlp(gen: torch.Generator, d: int, f: int, act: str,
             dtype: torch.dtype) -> Tree:
    specs = {"wi": ((d, f), ("embed", "mlp"))}
    if mlp_gated(act):
        specs["wg"] = ((d, f), ("embed", "mlp"))
    specs["wo"] = ((f, d), ("mlp", "embed"))
    return build(gen, specs, dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                       # jax.nn.gelu's tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu2":                      # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def apply_mlp(params: Mapping, x: torch.Tensor, act: str) -> torch.Tensor:
    h = ft_einsum("bsd,df->bsf", x, params["wi"])
    if mlp_gated(act):
        g = ft_einsum("bsd,df->bsf", x, params["wg"])
        h = _act(act, g) * h
    else:
        h = _act(act, h)
    return ft_einsum("bsf,fd->bsd", h, params["wo"])


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE sections for qwen2-vl)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: tuple = ()) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) or (B, S, 3) for M-RoPE.

    M-RoPE (qwen2-vl): the hd/2 frequency slots are split into
    ``sections`` = (t, h, w) groups; each group rotates by its own position
    stream. Text tokens carry the same id in all three streams, reducing to
    standard RoPE.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    if positions.dim() == 2:
        angles = positions[..., None].float() * freqs            # (B,S,hd/2)
    else:
        if not sections or sum(sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {sections} do not split "
                             f"hd/2 = {hd // 2}")
        parts = []
        start = 0
        for i, sec in enumerate(sections):
            f = freqs[start:start + sec]
            parts.append(positions[..., i, None].float() * f)
            start += sec
        angles = torch.cat(parts, dim=-1)                       # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, d) in f32: the sines
    of the d/2 frequencies, then their cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    inv = torch.exp(-math.log(10_000.0) * dim / d)
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               tie: bool) -> Tree:
    # stddev 1/sqrt(d): with the sqrt(d) input multiplier this gives
    # unit-variance activations AND O(1) tied logits.
    specs = {"embedding": ((vocab, d), ("vocab", "embed"), d ** -0.5)}
    if not tie:
        specs["unembed"] = ((d, vocab), ("embed", "vocab"))
    return build(gen, specs, dtype)


def embed(params: Mapping, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(params["embedding"], DTensor):
        return lookup(params["embedding"], tokens)
    return params["embedding"][tokens]


def scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s`` with ``s`` rounded to x's dtype first, as the reference's
    ``x * jnp.asarray(s, x.dtype)`` (a bf16 tensor times a Python float
    would multiply by the unrounded f32 value)."""
    return x * torch.tensor(s, dtype=x.dtype, device=x.device)


def logits(params: Mapping, x: torch.Tensor, *, tie: bool) -> torch.Tensor:
    """f32 logits (B, S, V). The operands are upcast, so a bf16 model's
    products are exact in f32 and accumulate in f32, as the reference's
    ``preferred_element_type=float32``; a bf16-output product would round
    the logits and move greedy ties. On a mesh they stay vocab-sharded."""
    w = params["embedding"].float().t() if tie else params["unembed"].float()
    if isinstance(w, DTensor):
        out = contract("bsd,dv->bsv", x.float(), w, ("bs", ["d"], "v"))
    else:
        out = torch.matmul(x.float(), w)
    return constrain(out, ("batch", None, "vocab"))
