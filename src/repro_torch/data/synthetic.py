"""Synthetic token pipeline for LM training and serving.

The port of ``repro.data.synthetic``: deterministic per (seed, step,
shard), each data-parallel shard drawing its own slice of the global
batch. ``next_batch(step)`` makes the reference's numpy draws, so tokens
and labels are equal value for value, and returns them as int64 tensors on
the pipeline's device (the card unless the caller asks for the CPU).

A model with a frontend also takes the embeddings the reference's
``input_specs`` gives its train batch: ``patch_embeds`` (B, num_patches,
d_model) for the vision stub, ``audio_embeds`` (B, encoder_seq, d_model)
for the audio stub (:func:`frontend_embeds`). The reference's pipeline
draws none (its specs give shapes only), so the port draws them as
standard normals with numpy from a generator of their own, seeded by
(seed, step, shard, 1), and casts them to the model's dtype; the tokens'
draws stay the reference's. :meth:`TokenPipeline.for_config` sets them
from a config.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.api.estimator import resolve_device


def frontend_embeds(cfg) -> dict[str, tuple[int, int]]:
    """The frontend inputs of ``cfg``'s train batch by name, each (rows,
    width) a batch row: the reference's ``input_specs``."""
    if cfg.frontend == "vision_stub":
        return {"patch_embeds": (cfg.num_patches, cfg.d_model)}
    if cfg.frontend == "audio_stub":
        return {"audio_embeds": (cfg.encoder_seq, cfg.d_model)}
    return {}


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    device: Any = "cuda"
    # frontend inputs drawn beside the tokens: name -> (rows, width)
    embeds: dict = dataclasses.field(default_factory=dict)
    embed_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_shards {self.num_shards}")
        self.local_batch = self.global_batch // self.num_shards
        self.device = resolve_device(self.device)

    @classmethod
    def for_config(cls, cfg, seq_len: int, global_batch: int,
                   **kw) -> "TokenPipeline":
        """The pipeline of ``cfg``'s train batches: its vocabulary, and its
        frontend's embeddings in its dtype."""
        return cls(cfg.vocab_size, seq_len, global_batch,
                   embeds=frontend_embeds(cfg),
                   embed_dtype=getattr(torch, cfg.dtype), **kw)

    def next_batch(self, step: int) -> dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step, self.shard))
        toks = rng.integers(0, self.vocab_size,
                            size=(self.local_batch, self.seq_len + 1),
                            dtype=np.int64)
        # structure so the loss can decrease: repeated motifs
        pos = np.arange(self.seq_len + 1)[None, :]
        motif = (pos * 31 + (step % 7)) % min(self.vocab_size, 997)
        mask = rng.uniform(size=toks.shape) < 0.7
        toks = torch.from_numpy(np.where(mask, motif, toks)).to(self.device)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.embeds:
            erng = np.random.default_rng((self.seed, step, self.shard, 1))
            for name, (rows, width) in sorted(self.embeds.items()):
                x = erng.standard_normal((self.local_batch, rows, width),
                                         dtype=np.float32)
                out[name] = torch.from_numpy(x).to(self.device,
                                                   self.embed_dtype)
        return out
