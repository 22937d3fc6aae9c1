"""The train step: micro-batched gradients, then AdamW, on one device or
on a ``(data, model)`` mesh of ranks.

The port of ``repro.train.steps.build_train_step``. The reference jits a step
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

On a mesh (``mesh=``, a ``DeviceMesh`` from ``repro_torch.launch.mesh``)
the model's parameters are ``DTensor``s placed by their logical axes
(``sharding.shard_params``) and the optimizer state carries the same
placements (``init_opt_state``). The step shards each micro-batch's rows
over the data axes (the reference's ``_batch_sharding``), runs under the
active mesh (``sharding.mesh_as``: cleared on leaving, and plain tensors
such as positions, masks and scalars taken as replicated), redistributes
each gradient to its parameter's placements and accumulates it into a
buffer of those placements, never a replicated one. Only the dense family
without ABFT runs on a mesh of more than one rank
(:func:`check_mesh_supported`).

The step's parts run under ``torch.profiler.record_function`` ranges named
in ``SPLIT_RANGES`` (each micro-batch's forward and backward, the
accumulation into the buffer, the optimizer), so a profiler trace of a
step reads its split (``chip_smoke.py`` phase 17); with no profiler
running a range costs a few microseconds of host time.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.profiler import record_function

from repro_torch.api.estimator import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.ft import abft_dense
from repro_torch.models.model import LM
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


def check_mesh_supported(cfg: ArchConfig, mesh: Any) -> None:
    """Raise ``NotImplementedError`` for what a mesh of more than one rank
    does not run yet: a family other than dense (its placements are held,
    its sharded step is not), and ABFT (``ft_einsum``'s correction takes an
    argmax and an ``index_add_`` over the whole product)."""
    if mesh is None or mesh.size() <= 1:
        return
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family does not train on a mesh "
            f"of {mesh.size()} ranks yet (only 'dense' does)")
    if cfg.abft:
        raise NotImplementedError(
            f"{cfg.name}: ABFT does not run on a mesh of {mesh.size()} ranks "
            f"yet (its correction indexes the whole product)")


def _batch_placements(mesh: Any, t: torch.Tensor) -> tuple:
    """A batch input's placements: rows over the data axes (a 0-d input or
    a batch of one row replicated), the reference's ``_batch_sharding``."""
    rows = t.dim() > 0 and t.shape[0] > 1
    return tuple(Shard(0) if rows and a != "model" else Replicate()
                 for a in shd.mesh_shape(mesh))


def _placed_batch(mesh: Any, batch: dict, dev: torch.device) -> dict:
    if mesh is None:
        return batch
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v.to(dev), mesh, _batch_placements(mesh, v),
                                 src_data_rank=None)
            for k, v in batch.items()}


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient at ``p``'s placements (zeros when it has none)."""
    g = p.grad
    if g is None:
        return torch.zeros_like(p)
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def build_train_step(cfg: ArchConfig, shape: ShapeConfig,
                     tcfg: Optional[opt_mod.TrainConfig] = None, *,
                     device: Any = "cuda", mesh: Any = None) -> Callable:
    """``step(lm, opt_state, batch) -> metrics``: one AdamW step of ``lm``
    (its parameters made trainable) on ``batch`` (moved to ``device``),
    updating ``lm``'s parameters and ``opt_state`` in place. The metrics
    ({"loss", "ce", "aux", "lr", "grad_norm"}) are device tensors: the step
    reads nothing back to the host. ``step.tcfg`` is the train config: by
    default the reference's, the config's moment dtype also for the
    accumulation buffer. With ``mesh``, ``lm``'s parameters and the
    optimizer state are placed on it (``sharding.shard_params``,
    ``init_opt_state``) and ``batch`` is the global batch, whole on every
    rank; the metrics are the global ones, plain tensors on every rank."""
    tcfg = tcfg or opt_mod.TrainConfig(
        opt_state_dtype=cfg.opt_state_dtype,
        grad_accum=cfg.grad_accum_override or default_grad_accum(shape),
        accum_dtype=cfg.opt_state_dtype)
    accum = max(tcfg.grad_accum, 1)
    acc_dt = getattr(torch, tcfg.accum_dtype)
    dev = resolve_device(device)
    check_mesh_supported(cfg, mesh)

    def step(lm, opt_state: dict, batch: dict) -> dict:
        abft_dense.configure(cfg.abft)
        lm.requires_grad_(True)
        params = dict(lm.named_parameters())
        for p in params.values():
            p.grad = None
        rows = next(iter(batch.values())).shape[0]
        if rows % accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{accum} micro-batches")
        mb = rows // accum
        micros = [_placed_batch(mesh, {k: v[i * mb:(i + 1) * mb].to(dev)
                                       for k, v in batch.items()}, dev)
                  for i in range(accum)]
        with shd.mesh_as(mesh):
            return _step(lm, opt_state, params, micros)

    def _step(lm, opt_state, params, micros):
        if accum > 1:
            grads = {n: torch.zeros_like(p, dtype=acc_dt)
                     for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for micro in micros:
                with record_function(FORWARD):
                    loss, metrics = lm.loss(micro)
                with record_function(BACKWARD):
                    loss.backward()
                with torch.no_grad(), record_function(ACCUMULATE):
                    for n, p in params.items():
                        if p.grad is not None:
                            grads[n] += _grad(p).to(acc_dt)
                            p.grad = None
                lsum = lsum + _full(loss.detach())
            with torch.no_grad(), record_function(ACCUMULATE):
                for g in grads.values():
                    g.div_(accum)
            loss = lsum / accum
        else:
            with record_function(FORWARD):
                loss, metrics = lm.loss(micros[0])
            with record_function(BACKWARD):
                loss.backward()
            grads = {n: _grad(p) for n, p in params.items()}
            loss = _full(loss.detach())
            for p in params.values():
                p.grad = None
        with record_function(OPTIMIZER):
            ometrics = opt_mod.adamw_update(params, grads, opt_state, tcfg)
        del grads
        return {"ce": _full(metrics["ce"].detach()),
                "aux": _full(metrics["aux"].detach()), "loss": loss,
                **ometrics}

    step.tcfg = tcfg
    return step


def abstract_train_state(cfg: ArchConfig, mesh: Any,
                         tcfg: opt_mod.TrainConfig):
    """(meta ``LM``, its parameters' :class:`~repro_torch.dist.sharding.
    Abstract` placements, the optimizer state's, the logical axes): the
    reference's ``abstract_train_state``, at any size, over any mesh (a
    ``DeviceMesh`` or one with ``axis_names`` and ``shape``)."""
    lm = LM(cfg, device="meta")
    axes = lm.param_axes()
    params = dict(lm.named_parameters())
    dt = getattr(torch, tcfg.opt_state_dtype)
    moments = {n: torch.empty(p.shape, dtype=dt, device="meta")
               for n, p in params.items()}
    opt = {"m": shd.shard_params(mesh, moments, axes),
           "v": shd.shard_params(mesh, moments, axes),
           "step": shd.Abstract((), torch.int32, tuple(
               Replicate() for _ in shd.mesh_shape(mesh)))}
    return lm, shd.shard_params(mesh, params, axes), opt, axes


__all__ = ["SPLIT_RANGES", "abstract_train_state", "build_train_step",
           "check_mesh_supported", "default_grad_accum"]
