"""The train step: micro-batched gradients, then AdamW.

The port of ``repro.train.steps.build_train_step`` on one device (no mesh:
LM-side sharding is not ported yet). The reference jits a step
that splits the batch into ``grad_accum`` micro-batches, adds each one's
gradients into a buffer of ``accum_dtype`` (f32 unless the config says
bf16), divides by the count and runs AdamW; the port runs the same eagerly:
per micro-batch ``loss.backward()``, then ``p.grad`` widened into a
separate buffer of ``accum_dtype`` and dropped, so ``.grad`` never sums
micro-batches in the parameters' dtype. With one micro-batch the gradients
are ``p.grad`` as they are (the parameters' dtype, as the reference's
``value_and_grad``). The parameters and the optimizer state are updated in
place (:func:`repro_torch.train.optimizer.adamw_update`). The reference's
``build_serve_steps`` has no counterpart: the port serves through
``repro_torch.launch.serve``.

The step's parts run under ``torch.profiler.record_function`` ranges named
in ``SPLIT_RANGES`` (each micro-batch's forward and backward, the
accumulation into the buffer, the optimizer), so a profiler trace of a
step reads its split (``chip_smoke.py`` phase 17); with no profiler
running a range costs a few microseconds of host time.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.api.estimator import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.ft import abft_dense
from repro_torch.train import optimizer as opt_mod

SPLIT_RANGES = ("train_step.forward", "train_step.backward",
                "train_step.accumulate", "train_step.optimizer")
FORWARD, BACKWARD, ACCUMULATE, OPTIMIZER = SPLIT_RANGES


def default_grad_accum(shape: ShapeConfig) -> int:
    """The reference's micro-batch count: 4 from a global batch of 64 (the
    activations of a full-sequence step under remat), else 1."""
    if shape.global_batch >= 64:
        return 4
    return 1


def build_train_step(cfg: ArchConfig, shape: ShapeConfig,
                     tcfg: Optional[opt_mod.TrainConfig] = None, *,
                     device: Any = "cuda") -> Callable:
    """``step(lm, opt_state, batch) -> metrics``: one AdamW step of ``lm``
    (its parameters made trainable) on ``batch`` (moved to ``device``),
    updating ``lm``'s parameters and ``opt_state`` in place. The metrics
    ({"loss", "ce", "aux", "lr", "grad_norm"}) are device tensors: the step
    reads nothing back to the host. ``step.tcfg`` is the train config: by
    default the reference's, the config's moment dtype also for the
    accumulation buffer."""
    tcfg = tcfg or opt_mod.TrainConfig(
        opt_state_dtype=cfg.opt_state_dtype,
        grad_accum=cfg.grad_accum_override or default_grad_accum(shape),
        accum_dtype=cfg.opt_state_dtype)
    accum = max(tcfg.grad_accum, 1)
    acc_dt = getattr(torch, tcfg.accum_dtype)
    dev = resolve_device(device)

    def step(lm, opt_state: dict, batch: dict) -> dict:
        abft_dense.configure(cfg.abft)
        lm.requires_grad_(True)
        params = dict(lm.named_parameters())
        batch = {k: v.to(dev) for k, v in batch.items()}
        for p in params.values():
            p.grad = None
        if accum > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % accum:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{accum} micro-batches")
            mb = rows // accum
            grads = {n: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                with record_function(FORWARD):
                    loss, metrics = lm.loss(micro)
                with record_function(BACKWARD):
                    loss.backward()
                with torch.no_grad(), record_function(ACCUMULATE):
                    for n, p in params.items():
                        if p.grad is not None:
                            grads[n] += p.grad.to(acc_dt)
                            p.grad = None
                lsum = lsum + loss.detach()
            with torch.no_grad(), record_function(ACCUMULATE):
                for g in grads.values():
                    g.div_(accum)
            loss = lsum / accum
        else:
            with record_function(FORWARD):
                loss, metrics = lm.loss(batch)
            with record_function(BACKWARD):
                loss.backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            loss = loss.detach()
            for p in params.values():
                p.grad = None
        with record_function(OPTIMIZER):
            ometrics = opt_mod.adamw_update(params, grads, opt_state, tcfg)
        del grads
        return {"ce": metrics["ce"].detach(), "aux": metrics["aux"].detach(),
                "loss": loss, **ometrics}

    step.tcfg = tcfg
    return step


__all__ = ["SPLIT_RANGES", "build_train_step", "default_grad_accum"]
