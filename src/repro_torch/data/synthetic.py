"""Synthetic token pipeline for LM training and serving.

The port of ``repro.data.synthetic``: deterministic per (seed, step,
shard), each data-parallel shard drawing its own slice of the global
batch. ``next_batch(step)`` makes the reference's numpy draws, so tokens
and labels are equal value for value, and returns them as int64 tensors on
the pipeline's device (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.api.estimator import resolve_device


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    device: Any = "cuda"

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_shards {self.num_shards}")
        self.local_batch = self.global_batch // self.num_shards
        self.device = resolve_device(self.device)

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
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
