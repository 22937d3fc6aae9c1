"""The k-means mesh over ``torch.distributed`` ranks (counterpart of the
k-means half of ``repro.dist.sharding``).

The reference lays jax devices on a ``("host", "row", "problem")`` grid and
lets ``shard_map`` reduce over named axes. The port lays global *ranks* on
the same grid (:class:`RankMesh`, built by :func:`mesh2d`) and gives each
rank the process group of every set of axes it may reduce over: the ranks
that share its coordinates on the other axes (:meth:`RankMesh.group`). A
rank is a process, so two ranks may share one card (each group's transport
is the process group's backend: NCCL with one card a rank, gloo on the CPU
or for several ranks on one card).

Groups are made with ``new_group(ranks, use_local_synchronization=True)``:
only their members call it, so survivors of a worker loss can group
without the lost rank. Torch names such a group by its members and by the
number of groups the process already holds, so every member must hold as
many when it is made: a mesh makes the groups of every axis set at once,
in one order (each rank of a grid is in one group per axis set, so every
member makes as many), and a set of members gets its group once per
process. :func:`run_ranks` starts a local group of ranks for tests and
``chip_smoke.py``. The LM-side sharding (``shard_params``, ``constrain``,
``fsdp_hint``, ``active_mesh``) is not ported yet.
"""
from __future__ import annotations

import datetime
import itertools
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("host", "row", "problem")

# members -> (the default group it was made under, the group): one group a
# set of members and a process (see the module docstring)
_GROUPS: dict = {}


def _group_of(members: tuple) -> Any:
    world = dist.group.WORLD
    hit = _GROUPS.get(members)
    if hit is None or hit[0] is not world:
        hit = (world, dist.new_group(list(members),
                                     use_local_synchronization=True))
        _GROUPS[members] = hit
    return hit[1]


class RankMesh:
    """Global ranks on a grid with named axes (the port's ``Mesh``).

    ``ranks`` is an integer array, one axis per name. ``shape`` maps each
    axis name to its size, in order. A member rank makes its groups when the
    mesh is built (all members of the mesh must build it); a rank outside the
    mesh makes none and may not ask for one.
    """

    def __init__(self, ranks: Any, axis_names: Sequence[str]) -> None:
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"a {self.ranks.ndim}-d rank grid needs as many "
                             f"axis names, got {self.axis_names}")
        if len(set(self.ranks.ravel().tolist())) != self.ranks.size:
            raise ValueError(f"a rank appears twice in {self.ranks.tolist()}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self._groups: dict = {}
        if dist.is_initialized() and self.contains(dist.get_rank()):
            for n in range(1, len(self.axis_names) + 1):
                for axes in itertools.combinations(self.axis_names, n):
                    self._groups[axes] = _group_of(self.members(axes))

    def flat(self) -> list[int]:
        """The ranks in grid order (row-major over the axes)."""
        return self.ranks.ravel().tolist()

    def contains(self, rank: int) -> bool:
        return bool((self.ranks == rank).any())

    def coords(self, rank: Optional[int] = None) -> dict:
        """This (or ``rank``'s) position: axis name -> index."""
        rank = dist.get_rank() if rank is None else rank
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return dict(zip(self.axis_names, where[0].tolist()))

    def _axes(self, axes: Sequence[str]) -> tuple:
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def members(self, axes: Sequence[str], rank: Optional[int] = None
                ) -> tuple:
        """The ranks that share ``rank``'s coordinates off ``axes``, in grid
        order: the ranks a reduce over ``axes`` sums."""
        axes = self._axes(axes)
        pos = self.coords(rank)
        index = tuple(slice(None) if a in axes else pos[a]
                      for a in self.axis_names)
        return tuple(self.ranks[index].ravel().tolist())

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """``rank``'s position among :meth:`members` of ``axes``: the block
        of data it holds when the data shards over those axes."""
        rank = dist.get_rank() if rank is None else rank
        return self.members(axes, rank).index(rank)

    def size_of(self, axes: Sequence[str]) -> int:
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def group(self, axes: Sequence[str]) -> Any:
        """The process group over ``axes`` of this rank's mesh position, or
        ``None`` for no axes (a reduce over nothing)."""
        axes = self._axes(axes)
        if not axes:
            return None
        if axes not in self._groups:
            raise ValueError(f"rank {dist.get_rank()} holds no group of this "
                             f"mesh (it is not a member, or the mesh was built"
                             f" before init_process_group)")
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, ranks={self.flat()})"


def data_axes(mesh: RankMesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: every axis but ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def mesh2d(rows: int, problems: int = 1, *, hosts: int = 1,
           ranks: Optional[Sequence[int]] = None) -> RankMesh:
    """The k-means mesh ``("host", "row", "problem")`` over ranks.

    ``rows`` is the total row parallelism, ``hosts x (rows // hosts)``, so
    the centroid reduce can run in two hops (``dist/reduce.py``);
    ``problems`` shards a ``BatchedKMeans`` stack. ``ranks`` (default: the
    first ``rows * problems`` ranks of the default group) fill the grid in
    order. ``mesh2d(4)`` is a flat data-parallel mesh with size-1 axes,
    ``mesh2d(1, 4)`` pure problem sharding.
    """
    if rows < 1 or problems < 1 or hosts < 1:
        raise ValueError(f"mesh2d needs positive sizes, got rows={rows} "
                         f"problems={problems} hosts={hosts}")
    if rows % hosts:
        raise ValueError(f"rows={rows} must divide over hosts={hosts}")
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized()
                      else rows * problems)
    ranks = list(ranks)
    need = rows * problems
    if len(ranks) < need:
        raise ValueError(f"mesh2d({rows}, {problems}) needs {need} ranks, "
                         f"only {len(ranks)} available")
    grid = np.asarray(ranks[:need]).reshape(hosts, rows // hosts, problems)
    return RankMesh(grid, AXES)


# ---------------------------------------------------------------------------
# A local group of ranks: tests and chip_smoke.py
# ---------------------------------------------------------------------------

def rank_device(device: str, rank: int) -> torch.device:
    """A rank's device: "cpu", an explicit "cuda:i" for every rank, or
    "cuda" for card ``rank % device_count`` (one card a rank where there are
    enough, else ranks share)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(fn: Callable, rank: int, world: int, device: str,
               backend: str, timeout: float, store: str, log: str,
               results: Any, args: tuple) -> None:
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        torch.set_num_threads(1)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *, device: str, backend: str,
              timeout: float, args: tuple = ()) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks
    joined in a ``backend`` process group ("gloo" or "nccl"; nothing
    switches over) and return their results in rank order.

    The group meets through a ``FileStore`` in a temporary directory (no
    port). ``fn`` is a module-level function; what it returns crosses a
    pipe, so it should hold CPU tensors or numpy arrays. Each rank's output
    goes to a log; when a rank fails, or the ranks are not all done within
    ``timeout`` seconds (also the group's collective timeout), every rank is
    killed and this raises with the logs' ends.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        results = ctx.Queue()
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, device, backend, timeout,
            os.path.join(tmp, "store"), logs[r], results, args))
            for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        failure = None
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world and failure is None:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in out]
                    if dead:
                        try:    # a rank's last word may still be in the pipe
                            rank, ok, value = results.get(timeout=2.0)
                        except queue_mod.Empty:
                            failure = (f"rank(s) {dead} exited without a "
                                       f"result")
                            continue
                    elif time.monotonic() > deadline:
                        late = sorted(set(range(world)) - set(out))
                        failure = f"ranks {late} not done within {timeout} s"
                        break
                    else:
                        continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
            # the first error may be another rank's consequence (a peer
            # that left): take what the others report for a moment more
            end = time.monotonic() + 2.0
            while failure is not None and time.monotonic() < min(
                    end, deadline):
                try:
                    rank, ok, value = results.get(
                        timeout=max(0.0, end - time.monotonic()))
                except queue_mod.Empty:
                    break
                if not ok:
                    failure += f"\nrank {rank} raised:\n{value}"
        finally:
            if failure is not None:
                for p in procs:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failure is not None:
            tails = []
            for r, path in enumerate(logs):
                if os.path.exists(path):    # a rank that never started has none
                    with open(path, errors="replace") as fh:
                        tails.append(f"--- rank {r} ---\n"
                                     f"{fh.read()[-3000:]}")
            raise RuntimeError(f"run_ranks: {failure}\n" + "\n".join(tails))
        return [out[r] for r in range(world)]
