"""Model factory: ArchConfig -> an ``nn.Module`` LM (forward, prefill, decode).

The port of ``repro.models.model``. The reference stacks full periods of
its ``layer_pattern`` and runs them under ``jax.lax.scan``; the port keeps
one block per layer in an ``nn.ModuleList`` and loops over it, and its
caches are one dict per layer (``convert`` maps both stackings). Every
parameter carries its logical axes (:meth:`LM.param_axes`, the reference's
axes tree keyed by state-dict name), and the residual stream is pinned to
the batch sharding after each mixer and FFN (``sharding.constrain``, a
no-op without a mesh): ``repro_torch.train`` runs the model on a ``(data,
model)`` mesh of ranks with its parameters as ``DTensor``s.

Every family of the reference: dense and MoE decoders (``ATTN`` and
``ATTN_LOCAL`` blocks, the MoE FFN on every ``moe.interleave``-th layer),
Mamba-2 (``SSM`` blocks, no FFN), the RecurrentGemma hybrid (``RGLRU``
blocks), the vision stub's early fusion (patch embeddings over the first
positions, M-RoPE grid positions for them) and the whisper-style
encoder-decoder (a non-causal encoder over the audio frames with
sinusoidal positions, a cross-attention in every decoder layer). The
encoder runs in the model's activation dtype: the audio frames plus their
positions are rounded to it once (the reference keeps the frames' dtype,
so f32 frames would carry an f32 residual stream into a bf16 decoder).

Weights are drawn from a seed (``init``), in f32 on the model's device,
and cast to ``cfg.param_dtype`` (f32 leaves of the SSD and RG-LRU blocks
stay f32). They are frozen (serving runs without autograd) until a trainer
calls ``lm.requires_grad_(True)``. ``LM(cfg, device="meta")`` holds
shapes only (placements at any size). :meth:`LM.loss` is the reference's
training loss; with ``cfg.remat`` and grad enabled every block (decoder and
encoder) runs under ``torch.utils.checkpoint`` (non-reentrant), the
reference's ``jax.checkpoint`` of its scanned periods taken one layer at a
time: a block's activations are recomputed in the backward.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.api.estimator import resolve_device
from repro_torch.configs.base import ATTN, ATTN_LOCAL, RGLRU, SSM, ArchConfig
from repro_torch.dist import sharding as shd
from repro_torch.ft import abft_dense
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod

KINDS = (ATTN, ATTN_LOCAL, RGLRU, SSM)
FRONTENDS = ("none", "vision_stub", "audio_stub")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a block kind or frontend no model has."""
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")
    for i in range(cfg.num_layers):
        if cfg.pattern_for_layer(i) not in KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind "
                             f"{cfg.pattern_for_layer(i)!r}")


def _moe_on_layer(cfg: ArchConfig, layer_idx: int) -> bool:
    return cfg.moe is not None and \
        layer_idx % cfg.moe.interleave == cfg.moe.interleave - 1


class Params(nn.Module):
    """A (nested) dict of parameters, indexed like the dict: tensors become
    ``nn.Parameter``s, frozen until ``requires_grad_(True)``, sub-dicts (MoE's
    ``shared`` MLP, the SSD block's ``norm``) ``Params`` of their own, so
    the state-dict keys are the dotted paths of the reference's tree.
    ``axes`` holds each parameter's logical axes (``layers.Tree.axes``)."""

    def __init__(self, params: dict):
        super().__init__()
        self.axes = dict(getattr(params, "axes", {}))
        for name, v in params.items():
            if isinstance(v, dict):
                self.add_module(name, Params(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Block(nn.Module):
    """One layer: norm -> mixer -> residual, [norm -> cross-attention ->
    residual], [norm -> MLP or MoE -> residual]. The mixer is attention
    (``ATTN``, or ``ATTN_LOCAL`` with a ring-buffer window), an RG-LRU or
    an SSD block; SSD blocks have no FFN."""

    def __init__(self, cfg: ArchConfig, kind: str, gen: torch.Generator,
                 dtype: torch.dtype, *, moe: bool = False,
                 cross: bool = False):
        super().__init__()
        dev = gen.device
        self.cfg, self.kind, self.cross_attends = cfg, kind, cross
        self.window = cfg.local_window if kind == ATTN_LOCAL else 0
        self.norm1 = Params(L.init_rmsnorm(cfg.d_model, dtype, dev))
        if kind in (ATTN, ATTN_LOCAL):
            self.mix = Params(attn_mod.init_attention(gen, cfg, dtype))
        elif kind == RGLRU:
            self.mix = Params(rglru_mod.init_rglru(gen, cfg, dtype))
        elif kind == SSM:
            self.mix = Params(ssm_mod.init_ssm(gen, cfg, dtype))
        else:
            raise ValueError(kind)
        if cross:
            self.norm_x = Params(L.init_rmsnorm(cfg.d_model, dtype, dev))
            self.cross = Params(attn_mod.init_attention(gen, cfg, dtype))
        self.moe = moe and kind != SSM
        if kind != SSM:
            self.norm2 = Params(L.init_rmsnorm(cfg.d_model, dtype, dev))
            self.ffn = Params(moe_mod.init_moe(gen, cfg, dtype) if self.moe
                              else L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                              cfg.mlp_act, dtype))

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> dict:
        """This layer's empty decode cache."""
        if self.kind == RGLRU:
            return {"rglru": rglru_mod.init_cache(self.cfg, batch, dtype,
                                                  device)}
        if self.kind == SSM:
            return {"ssm": ssm_mod.init_cache(self.cfg, batch, dtype,
                                              device)}
        return {"kv": attn_mod.init_cache(self.cfg, batch, max_len,
                                          window=self.window, dtype=dtype,
                                          device=device)}

    def forward(self, x, *, positions, cache=None, pos=None,
                make_cache=False, max_len=0, causal=True, encoder_out=None):
        """Returns (x, the new cache or None, the MoE aux loss)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = L.rmsnorm(self.norm1, x, cfg.norm_eps)
        if self.kind in (ATTN, ATTN_LOCAL):
            out, st = attn_mod.apply_attention(
                cfg, self.mix, h, positions=positions, causal=causal,
                window=self.window, cache=cache["kv"] if cache else None,
                pos=pos, make_cache=make_cache, max_len=max_len)
            key = "kv"
        else:
            if make_cache and cache is None:
                cache = self.init_cache(x.shape[0], max_len, x.dtype,
                                        x.device)
            key = "rglru" if self.kind == RGLRU else "ssm"
            apply = rglru_mod.apply_rglru if self.kind == RGLRU \
                else ssm_mod.apply_ssm
            out, st = apply(cfg, self.mix, h,
                            cache=cache[key] if cache else None)
        x = shd.constrain(x + out, ("batch", None, None))

        if self.cross_attends and encoder_out is not None:
            h = L.rmsnorm(self.norm_x, x, cfg.norm_eps)
            out, _ = attn_mod.apply_attention(cfg, self.cross, h,
                                              positions=positions,
                                              kv_input=encoder_out)
            x = x + out

        if self.kind != SSM:
            h = L.rmsnorm(self.norm2, x, cfg.norm_eps)
            if self.moe:
                out, aux = moe_mod.apply_moe(cfg, self.ffn, h)
            else:
                out = L.apply_mlp(self.ffn, h, cfg.mlp_act)
            x = shd.constrain(x + out, ("batch", None, None))
        return x, (None if st is None else {key: st}), aux


class LMCaches(list):
    """Decode caches: one dict a decoder layer (``{"kv": KVCache}``,
    ``{"rglru": RGLRUCache}`` or ``{"ssm": SSMCache}``), and for an
    encoder-decoder the encoder's output, ``encoder_out`` (else None)."""

    def __init__(self, layers=(), encoder_out: Optional[torch.Tensor] = None):
        super().__init__(layers)
        self.encoder_out = encoder_out


class LM(nn.Module):
    """An LM of any family on one device (``"cuda"`` unless asked for the
    CPU; ``"meta"`` for shapes only)."""

    def __init__(self, cfg: ArchConfig, *, device: Any = "cuda",
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device("meta") if torch.device(
            device).type == "meta" else resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.init(seed)

    # -- init ---------------------------------------------------------------

    def init(self, seed: int = 0) -> "LM":
        """Draw every weight anew from ``seed`` (norm scales are ones)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.param_dtype)
        gen = L.MetaGenerator() if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)
        self.embed = Params(L.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                         dtype, cfg.tie_embeddings))
        self.final_norm = Params(L.init_rmsnorm(cfg.d_model, dtype,
                                                self.device))
        self.layers = nn.ModuleList(
            Block(cfg, cfg.pattern_for_layer(i), gen, dtype,
                  moe=_moe_on_layer(cfg, i), cross=cfg.encoder_decoder)
            for i in range(cfg.num_layers))
        self.encoder = nn.ModuleList(
            Block(cfg, ATTN, gen, dtype, moe=_moe_on_layer(cfg, 0))
            for _ in range(cfg.encoder_layers if cfg.encoder_decoder else 0))
        return self

    def param_axes(self) -> dict:
        """{state-dict name: logical axes} of every parameter (the
        reference's axes tree; its stacked leaves' leading "layers" axis
        has no counterpart here)."""
        return {f"{path}.{name}" if path else name: mod.axes[name]
                for path, mod in self.named_modules()
                if isinstance(mod, Params) for name in mod._parameters}

    # -- embedding / positions ----------------------------------------------

    def _positions(self, batch: dict, b: int, s: int,
                   offset: int = 0) -> torch.Tensor:
        """(B, S) positions, or (B, S, 3) M-RoPE streams (t, h, w): the
        fused patch prefix of a prefill takes its grid's (0, row, column)."""
        base = torch.arange(s, dtype=torch.int32, device=self.device) + offset
        if not self.cfg.mrope_sections:
            return base[None, :].expand(b, s)
        pos = base[None, :, None].expand(b, s, 3).clone()
        if "patch_embeds" in batch and offset == 0:
            npatch = batch["patch_embeds"].shape[1]
            side = max(int(npatch ** 0.5), 1)
            idx = torch.arange(npatch, dtype=torch.int32, device=self.device)
            pos[:, :npatch] = torch.stack(
                [torch.zeros_like(idx), idx // side, idx % side], dim=-1)
        return pos

    def _embed_inputs(self, batch: dict) -> torch.Tensor:
        x = L.embed(self.embed, batch["tokens"])
        if self.cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            patches = batch["patch_embeds"]
            x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]],
                          dim=1)
        return L.scaled(x, self.cfg.d_model ** 0.5)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return L.logits(self.embed, x, tie=self.cfg.tie_embeddings)

    # -- encoder (whisper) ----------------------------------------------------

    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder stack over (B, S, D) audio frames (non-causal, with
        sinusoidal positions), in the model's activation dtype."""
        b, s, d = audio_embeds.shape
        sin = L.sinusoidal_positions(s, d, device=audio_embeds.device)
        x = (audio_embeds + sin.to(audio_embeds.dtype)[None]).to(self.dtype)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device)[None, :].expand(b, s)
        for layer in self.encoder:
            x, _, _ = self._run(layer, x, positions=positions, causal=False)
        return x

    def _run(self, layer, x, **kw):
        """One block, under ``torch.utils.checkpoint`` when ``cfg.remat``
        and grad are on (the reference's ``jax.checkpoint``). The recompute
        runs on autograd's thread with the ABFT switch and the mesh of the
        forward."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return layer(x, **kw)
        on, mesh = abft_dense.ft_enabled(), shd.active_mesh()

        def block(x, **kw):
            with abft_dense.enabled_as(on), shd.mesh_as(mesh):
                return layer(x, **kw)
        return checkpoint(block, x, use_reentrant=False, **kw)

    def _encoder_out(self, batch: dict) -> Optional[torch.Tensor]:
        if not self.cfg.encoder_decoder:
            return None
        return self.encode(batch["audio_embeds"].to(self.device))

    # -- full-sequence forward -----------------------------------------------

    def forward(self, batch: dict):
        """Full-sequence forward. Returns (logits f32, aux_loss): the summed
        MoE load-balancing loss (0 without MoE layers)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed_inputs(batch)
        positions = self._positions(batch, b, s)
        encoder_out = self._encoder_out(batch)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            x, _, a = self._run(layer, x, positions=positions,
                                encoder_out=encoder_out)
            aux = aux + a
        return self._head(x), aux

    def loss(self, batch: dict):
        """The reference's training loss: mean next-token cross-entropy of
        the f32 logits (padded-vocabulary columns set to -1e30 first) plus
        0.01 x the MoE aux loss. Returns (loss, {"ce", "aux"}). The label's
        log-probability is a gather; the reference's one-hot contraction
        gives the same f32 value (every other term of its sum is +-0)."""
        cfg = self.cfg
        logits, aux = self.forward(batch)
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab,
                               device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        logp = torch.log_softmax(logits, dim=-1)
        labels = batch["labels"].to(logp.device, torch.int64)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        ce = nll.mean()
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # -- serving --------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> LMCaches:
        """Empty caches: one dict a layer (ring buffers on local layers,
        zero states on RG-LRU and SSD layers), and zero encoder states."""
        enc = None
        if self.cfg.encoder_decoder:
            enc = torch.zeros((batch, self.cfg.encoder_seq, self.cfg.d_model),
                              dtype=self.dtype, device=self.device)
        return LMCaches((layer.init_cache(batch, max_len, self.dtype,
                                          self.device)
                         for layer in self.layers), encoder_out=enc)

    def prefill(self, batch: dict, max_len: int):
        """Forward over the prompt, building decode caches.

        Returns (logits (B, S, V) f32, caches); an encoder-decoder keeps the
        encoder's output in ``caches.encoder_out``."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed_inputs(batch)
        positions = self._positions(batch, b, s)
        encoder_out = self._encoder_out(batch)
        caches = LMCaches(encoder_out=encoder_out)
        for layer in self.layers:
            x, c, _ = layer(x, positions=positions, make_cache=True,
                            max_len=max_len, encoder_out=encoder_out)
            caches.append(c)
        return self._head(x), caches

    def decode_step(self, caches: list, tokens: torch.Tensor, pos: int, *,
                    encoder_out: Optional[torch.Tensor] = None):
        """One token for every sequence. tokens (B, 1), pos an int.

        Writes the token's keys and values into ``caches`` in place (and
        each RG-LRU / SSD layer's new state into its dict) and returns
        (logits (B, 1, V) f32, caches)."""
        if encoder_out is None:
            encoder_out = getattr(caches, "encoder_out", None)
        x = self._embed_inputs({"tokens": tokens})
        positions = self._positions({}, tokens.shape[0], 1, offset=int(pos))
        for layer, cache in zip(self.layers, caches):
            x, new, _ = layer(x, positions=positions, cache=cache, pos=pos,
                              encoder_out=encoder_out)
            cache.update(new)
        return self._head(x), caches


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Next tokens (B, 1) int32 from the last position's logits."""
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


__all__ = ["LM", "LMCaches", "Block", "Params", "check_supported", "greedy"]
