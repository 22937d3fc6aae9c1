"""AdamW with cosine, WSD and constant schedules.

The port of ``repro.train.optimizer`` as plain functions over dicts of
tensors keyed like ``LM.named_parameters()``. The reference's arithmetic
is kept step for step: the gradient widened to f32 and scaled by the
global-norm clip, f32 moments stored in ``opt_state_dtype``, no master
weights (the update runs in f32 on the widened parameter and is rounded
back to its dtype). The step counter, the learning rate and the clip scale
stay on the device: a step reads nothing back to the host. Where the
reference returns new arrays (donated to the jit), the port updates the
parameters, ``m`` and ``v`` in place under ``torch.no_grad()``: at full
width a second copy of each would not fit beside the first.

On a mesh the parameters are ``DTensor``s: ``m`` and ``v`` take their
placements, every update is elementwise on the local shards, and the clip's
global norm sums the squares of the whole tensors (each shard's partial
sum reduced over the ranks that split it), never of one rank's shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"        # cosine | wsd | constant
    wsd_decay_frac: float = 0.1
    min_lr_frac: float = 0.1
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"
    grad_accum: int = 1                # microbatches per step
    accum_dtype: str = "float32"       # grad-accumulation buffer dtype


def lr_at(cfg: TrainConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or a number) as an f32
    tensor on step's device, in the reference's f32 order of operations."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1),
                         torch.ones((), **f32))
    peak = torch.tensor(cfg.learning_rate, **f32)
    if cfg.schedule == "constant":
        return peak * warm
    if cfg.schedule == "wsd":
        decay_steps = max(int(cfg.total_steps * cfg.wsd_decay_frac), 1)
        decay_start = cfg.total_steps - decay_steps
        frac = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        stable = 1.0 - (1.0 - cfg.min_lr_frac) * frac
        return peak * warm * stable
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, **f32) * prog))
    return peak * warm * cos


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: TrainConfig) -> dict:
    """Zero moments in ``opt_state_dtype`` beside each parameter (with its
    placements, on a mesh), and the int32 step counter on the parameters'
    device."""
    dt = getattr(torch, cfg.opt_state_dtype)
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros_like(p, dtype=dt)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=dt)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares, in f32 (a ``DTensor``'s
    over the whole tensor)."""
    total = None
    for t in tensors:
        sq = torch.sum(torch.square(t.to(torch.float32)))
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: dict,
                 cfg: TrainConfig) -> dict:
    """One AdamW step, in place: ``params``, ``opt_state["m"]`` and
    ``["v"]`` are overwritten and ``["step"]`` advanced. Returns the
    metrics {"lr", "grad_norm"} as device tensors. On a mesh it runs
    inside the step's ``sharding.mesh_as`` (plain scalars meet the
    ``DTensor``s as replicated ones)."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads[n] for n in params)
    if cfg.grad_clip > 0:
        scale = torch.minimum(torch.ones_like(gnorm),
                              cfg.grad_clip / torch.clamp(gnorm, min=1e-9))
    else:
        scale = torch.ones_like(gnorm)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}
