"""Elastic scaling and straggler policy (counterpart of ``repro.ft.elastic``).

The recovery ladder, cheapest first: an SDC in a GEMM is corrected in the
kernel (ABFT); an SDC in a reduction is caught by DMR or by the reduce's
checksums; a straggling shard is dropped for an iteration
(:meth:`StragglerPolicy.aggregate` keeps the mean unbiased); a failed
worker (fail-stop) shrinks the mesh, reshards, restores the last snapshot
and resumes (``DistributedKMeans.fit_elastic``).

This module is the decision layer: given the live ranks it plans the new
mesh (:func:`plan_rescale_rows`) and builds it over them
(:func:`build_mesh`). In a drill, :class:`FailureSchedule` raises
:class:`WorkerLossError` at scheduled iterations on every rank at once, so
all ranks learn of a loss together without a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.dist.sharding import RankMesh


class WorkerLossError(RuntimeError):
    """A fail-stop worker loss: ``lost`` holds positions in the fit's
    current flat rank list (``mesh.flat()``)."""

    def __init__(self, lost: Sequence[int], message: str = ""):
        self.lost = tuple(lost)
        super().__init__(message or f"lost devices {self.lost}")


@dataclasses.dataclass
class FailureSchedule:
    """Deterministic worker-loss injector for drills: iteration -> the
    positions to lose. Passed as the fit's ``on_iteration`` hook, it raises
    :class:`WorkerLossError` when the loop reaches a scheduled iteration;
    each entry fires once (a resumed fit passes the same iterations
    again)."""

    schedule: dict

    def __call__(self, iteration: int) -> None:
        lost = self.schedule.pop(iteration, None)
        if lost:
            raise WorkerLossError(tuple(lost))


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    mesh_shape: tuple
    axis_names: tuple
    dropped_devices: tuple
    data_shards: int            # new number of data shards
    note: str = ""


def largest_mesh(n_devices: int, *, model_parallel: int,
                 pods: int = 1) -> tuple[int, ...]:
    """Largest (pod, data, model) grid that fits ``n_devices``, the model
    axis kept whole (its groups stay intact) and data shrunk."""
    per_pod = n_devices // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError(
            f"cannot keep model={model_parallel} with {n_devices} devices")
    return (pods, data, model_parallel) if pods > 1 else (data, model_parallel)


def plan_rescale(live_devices: Sequence, *, model_parallel: int,
                 pods: int = 1,
                 axis_names: tuple = ("data", "model")) -> ReshardPlan:
    """The post-failure grid: drops the fewest devices (positions past the
    grid) that make it rectangular with whole model groups."""
    n = len(live_devices)
    shape = largest_mesh(n - n % model_parallel, model_parallel=model_parallel,
                         pods=pods)
    used = int(np.prod(shape))
    dropped = tuple(range(used, n))
    names = (("pod",) + axis_names) if pods > 1 else axis_names
    data_shards = shape[-2] * (shape[0] if pods > 1 else 1)
    return ReshardPlan(
        mesh_shape=shape, axis_names=names, dropped_devices=dropped,
        data_shards=data_shards,
        note=f"{n} live -> mesh {shape} ({used} used, {len(dropped)} spare)")


def plan_rescale_rows(live_devices: Sequence, *, problems: int = 1,
                      hosts: int = 1) -> ReshardPlan:
    """:func:`plan_rescale` for the ``("host", "row", "problem")`` mesh:
    problem groups stay whole and rows shrink; the host grouping is kept
    where the surviving rows still divide over it, else collapses to one
    host group (the reduce's flat form)."""
    flat = plan_rescale(live_devices, model_parallel=problems)
    rows = flat.mesh_shape[0]
    h = hosts if hosts > 1 and rows % hosts == 0 else 1
    return dataclasses.replace(
        flat,
        mesh_shape=(h, rows // h, problems),
        axis_names=("host", "row", "problem"),
        data_shards=rows,
        note=f"{len(live_devices)} live -> mesh ({h}, {rows // h}, "
             f"{problems}) ({rows * problems} used, "
             f"{len(flat.dropped_devices)} spare)")


def build_mesh(plan: ReshardPlan, ranks: Sequence[int]) -> RankMesh:
    """The plan's mesh over the first ranks of ``ranks`` (the live ones)."""
    used = int(np.prod(plan.mesh_shape))
    grid = np.asarray(list(ranks)[:used]).reshape(plan.mesh_shape)
    return RankMesh(grid, plan.axis_names)


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based straggler mitigation: a shard later than
    ``deadline_factor`` x the median step time for ``strikes`` steps in a row
    is evicted (-> :func:`plan_rescale_rows`); until then its contribution is
    skipped, which :meth:`aggregate` keeps unbiased."""

    deadline_factor: float = 3.0
    strikes: int = 2
    _history: dict = dataclasses.field(default_factory=dict)

    def observe(self, shard: int, step_time: float,
                median_time: float) -> bool:
        """True when the shard should be evicted."""
        late = step_time > self.deadline_factor * max(median_time, 1e-9)
        count = self._history.get(shard, 0)
        count = count + 1 if late else 0
        self._history[shard] = count
        return count >= self.strikes

    @staticmethod
    def aggregate(sums, counts, live) -> tuple[torch.Tensor, torch.Tensor]:
        """Fold per-shard ``(sums, counts)`` with late or dead shards masked
        out: ``(sum of live sums, sum of live counts)``. Dropping a shard
        drops its rows from numerator and denominator alike, so the mean is
        exactly the mean of the live shards' rows. ``sums`` (S, K, F),
        ``counts`` (S, K), ``live`` (S,) bool; tensors or arrays."""
        sums = torch.as_tensor(sums)
        counts = torch.as_tensor(counts)
        mask = torch.as_tensor(live, dtype=torch.bool, device=sums.device)
        ms = mask.reshape((-1,) + (1,) * (sums.dim() - 1))
        mc = mask.reshape((-1,) + (1,) * (counts.dim() - 1))
        return (torch.where(ms, sums, 0.0).sum(0),
                torch.where(mc, counts, 0.0).sum(0))

