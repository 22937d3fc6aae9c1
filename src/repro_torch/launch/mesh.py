"""The LM meshes over ``torch.distributed`` ranks (the port of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group. Each builds a ``DeviceMesh`` of the default group's ranks,
row-major over its axes; every rank must call it, in the same order as
every other group it makes (``repro_torch.dist.sharding``). On a card, a
gloo group stages its gathers through host memory
(``sharding.stage_gathers_through_host``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd


def _mesh(shape: tuple, axes: tuple, device: Any):
    from torch.distributed.device_mesh import DeviceMesh
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need} ranks, "
                         f"the world has {world}")
    if not dist.is_initialized():
        raise RuntimeError("an LM mesh needs a process group: call "
                           "torch.distributed.init_process_group first "
                           "(torchrun sets WORLD_SIZE)")
    kind = torch.device(device).type
    if kind == "cuda" and dist.get_backend() == "gloo":
        shd.stage_gathers_through_host()
    return DeviceMesh(kind, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: Any = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_local_mesh(model_parallel: int = 1, *, device: Any = "cuda"):
    """Every rank of the world: (data = world // model_parallel,
    model = model_parallel)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {world} ranks")
    return _mesh((world // model_parallel, model_parallel),
                 ("data", "model"), device)


__all__ = ["make_local_mesh", "make_production_mesh"]
