"""Model factory: ArchConfig -> an ``nn.Module`` LM (forward, prefill, decode).

The port of ``repro.models.model``. The reference stacks full periods of
its ``layer_pattern`` and runs them under ``jax.lax.scan``; the port keeps
one block per layer in an ``nn.ModuleList`` and loops over it, and its
caches are one dict per layer (``convert`` maps both stackings). One
device, no mesh: the reference's sharding hints have no counterpart.

Ported: dense decoders of ``ATTN`` and ``ATTN_LOCAL`` blocks (internlm2,
gemma3, minicpm, nemotron). RG-LRU, SSD and MoE blocks, the encoder-decoder
and the vision/audio frontends raise ``NotImplementedError`` naming the
missing block or frontend.

Weights are drawn from a seed (``init``), in f32 on the model's device,
and cast to ``cfg.param_dtype``; they never require grad: serving runs
without autograd, training is a later slice.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.api.estimator import resolve_device
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L

_LATER = "comes with a later slice of the port"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder {_LATER}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"{_LATER}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks {_LATER}")
    for i in range(cfg.num_layers):
        kind = cfg.pattern_for_layer(i)
        if kind not in (ATTN, ATTN_LOCAL):
            raise NotImplementedError(f"{cfg.name}: {kind!r} blocks {_LATER}")


def _frozen(params: dict) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                             for name, t in params.items()})


class Block(nn.Module):
    """One decoder layer: norm -> attention -> residual, norm -> MLP ->
    residual. ``kind`` is ``ATTN`` or ``ATTN_LOCAL`` (ring-buffer window)."""

    def __init__(self, cfg: ArchConfig, kind: str, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        dev = gen.device
        self.cfg = cfg
        self.window = cfg.local_window if kind == ATTN_LOCAL else 0
        self.norm1 = _frozen(L.init_rmsnorm(cfg.d_model, dtype, dev))
        self.mix = _frozen(attn_mod.init_attention(gen, cfg, dtype))
        self.norm2 = _frozen(L.init_rmsnorm(cfg.d_model, dtype, dev))
        self.ffn = _frozen(L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                      dtype))

    def forward(self, x, *, positions, cache=None, pos=None,
                make_cache=False, max_len=0, causal=True):
        """Returns (x, new_cache)."""
        cfg = self.cfg
        h = L.rmsnorm(self.norm1, x, cfg.norm_eps)
        out, kv = attn_mod.apply_attention(
            cfg, self.mix, h, positions=positions, causal=causal,
            window=self.window, cache=cache["kv"] if cache else None, pos=pos,
            make_cache=make_cache, max_len=max_len)
        x = x + out
        h = L.rmsnorm(self.norm2, x, cfg.norm_eps)
        x = x + L.apply_mlp(self.ffn, h, cfg.mlp_act)
        return x, (None if kv is None else {"kv": kv})


class LM(nn.Module):
    """A decoder LM on one device (``"cuda"`` unless asked for the CPU)."""

    def __init__(self, cfg: ArchConfig, *, device: Any = "cuda",
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.init(seed)

    # -- init ---------------------------------------------------------------

    def init(self, seed: int = 0) -> "LM":
        """Draw every weight anew from ``seed`` (norm scales are ones)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.param_dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed = _frozen(L.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                          dtype, cfg.tie_embeddings))
        self.final_norm = _frozen(L.init_rmsnorm(cfg.d_model, dtype,
                                                 self.device))
        self.layers = nn.ModuleList(
            Block(cfg, cfg.pattern_for_layer(i), gen, dtype)
            for i in range(cfg.num_layers))
        return self

    # -- embedding / positions ----------------------------------------------

    def _positions(self, b: int, s: int, offset: int = 0) -> torch.Tensor:
        return (torch.arange(s, dtype=torch.int32, device=self.device)
                + offset)[None, :].expand(b, s)

    def _embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        x = L.embed(self.embed, tokens)
        return L.scaled(x, self.cfg.d_model ** 0.5)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return L.logits(self.embed, x, tie=self.cfg.tie_embeddings)

    # -- full-sequence forward -----------------------------------------------

    def forward(self, batch: dict):
        """Full-sequence forward. Returns (logits f32, aux_loss), aux 0 for
        the dense blocks ported here."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed_inputs(tokens)
        positions = self._positions(b, s)
        for layer in self.layers:
            x, _ = layer(x, positions=positions)
        return self._head(x), torch.zeros((), device=self.device)

    # -- serving --------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> list[dict]:
        """Empty caches, one dict per layer (ring buffers on local layers)."""
        return [{"kv": attn_mod.init_cache(self.cfg, batch, max_len,
                                           window=layer.window,
                                           dtype=self.dtype,
                                           device=self.device)}
                for layer in self.layers]

    def prefill(self, batch: dict, max_len: int):
        """Forward over the prompt, building decode caches.

        Returns (logits (B, S, V) f32, caches)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed_inputs(tokens)
        positions = self._positions(b, s)
        caches = []
        for layer in self.layers:
            x, c = layer(x, positions=positions, make_cache=True,
                         max_len=max_len)
            caches.append(c)
        return self._head(x), caches

    def decode_step(self, caches: list[dict], tokens: torch.Tensor, pos: int):
        """One token for every sequence. tokens (B, 1), pos an int.

        Writes the token's keys and values into ``caches`` in place and
        returns (logits (B, 1, V) f32, caches)."""
        x = self._embed_inputs(tokens)
        positions = self._positions(tokens.shape[0], 1, offset=int(pos))
        for layer, cache in zip(self.layers, caches):
            x, _ = layer(x, positions=positions, cache=cache, pos=pos)
        return self._head(x), caches


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Next tokens (B, 1) int32 from the last position's logits."""
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


__all__ = ["LM", "Block", "check_supported", "greedy"]
