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
``chip_smoke.py``.

The LM half (the reference's logical-axis sharding) maps logical axis
names onto a ``(data, model)`` ``DeviceMesh`` of ``torch.distributed.tensor``
(``launch/mesh.py`` builds it; every rank builds it, in one order):

  * model-parallel names ("mlp", "heads", "vocab", "experts", "seq_tp", ...)
    shard over the ``model`` mesh dimension;
  * ``fsdp`` (promoted onto the embed dim of large weights by
    :func:`fsdp_hint`) shards over the data dimensions (ZeRO-3 layout);
  * everything else replicates.

:func:`shard_params` turns parameters into ``DTensor``s with those
placements (``distribute_tensor``); :func:`constrain` pins an activation
with ``redistribute`` (the reference's ``with_sharding_constraint``) and is
a no-op without an active mesh, so single-device code runs unchanged.
Between the pins DTensor's propagation plays GSPMD's part for the
elementwise ops and the loss; the projections (:func:`contract`) and the
embedding lookup (:func:`lookup`) have their collectives written out,
since torch 2.11's DTensor has no rule for them. Its gloo crashes in
DTensor's functional ``all_gather_into_tensor`` of CUDA tensors, so on a
card a gloo mesh stages that one collective through host memory
(:func:`stage_gathers_through_host`).
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import queue as queue_mod
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

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


def mesh_shape(mesh: Any) -> dict:
    """{axis name: size} of a :class:`RankMesh`, a ``DeviceMesh`` or any
    mesh with ``axis_names`` and a ``shape`` mapping, in axis order."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: shape[a] for a in names}
    return dict(zip(names, shape))


def data_axes(mesh: Any) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: every axis but ``model``. Empty for
    a tensor-parallel-only mesh, never ``model`` (a placement list would
    claim it twice)."""
    return tuple(a for a in mesh_shape(mesh) if a != "model")


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
# The LM half: logical axes -> DTensor placements over a (data, model) mesh
# ---------------------------------------------------------------------------

# Logical name -> mesh-axis role; "data" stands for every data axis of the
# mesh (("pod", "data") on a multi-pod mesh).
_MODEL_NAMES = frozenset(
    {"mlp", "expert_mlp", "heads", "vocab", "experts", "seq_tp", "model"})
_DATA_NAMES = frozenset({"batch", "fsdp", "data"})

_FSDP_MIN_SIZE = 2 ** 20   # elements; below this replication is cheaper

_state = threading.local()


def set_active_mesh(mesh: Any) -> None:
    """This thread's LM mesh (``None``: one device)."""
    _state.mesh = mesh


def active_mesh() -> Any:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def plain_as_replicated():
    """DTensor's implicit replication for the block, then the setting it had
    (``implicit_replication`` clears it on leaving, which would end an
    enclosing block's): a plain tensor (positions, masks, scalars) meets a
    ``DTensor`` as a replicated one."""
    # DTensor's private switch (torch 2.11 on the card, 2.13 on the CPU);
    # tests/test_torch_lm_sharding.py fails when a torch drops it
    dispatch = DTensor._op_dispatcher
    before = dispatch._allow_implicit_replication
    dispatch._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatch._allow_implicit_replication = before


@contextlib.contextmanager
def mesh_as(mesh: Any):
    """This thread's mesh set to ``mesh`` for the block (with
    :func:`plain_as_replicated` when it is one), then restored. Autograd
    recomputes a checkpointed block on its own device thread, which must
    see the mesh the forward saw."""
    before = active_mesh()
    set_active_mesh(mesh)
    try:
        with plain_as_replicated() if mesh is not None \
                else contextlib.nullcontext():
            yield
    finally:
        set_active_mesh(before)


def fsdp_hint(shape: tuple, axes: tuple) -> tuple:
    """Promote the embed dim of large weights to 'fsdp' (ZeRO-3 layout).
    Small tensors stay replicated: their all-gather latency costs more than
    the memory they would save."""
    size = 1
    for s in shape:
        size *= s
    if size < _FSDP_MIN_SIZE:
        return tuple(axes)
    out = []
    promoted = False
    for name in axes:
        if not promoted and name == "embed":
            out.append("fsdp")
            promoted = True
        else:
            out.append(name)
    return tuple(out)


def _spec_for(mesh: Any, shape: tuple, axes: tuple) -> tuple:
    """The placements of one tensor, one per mesh dimension: the first
    divisible model-name dim takes ``model``, the first divisible data-name
    dim takes every data axis; a mesh axis is never used twice."""
    sizes = mesh_shape(mesh)
    daxes = data_axes(mesh)
    dp = 1
    for a in daxes:
        dp *= sizes[a]
    model_n = sizes.get("model", 1)
    where: dict = {}
    for i, (dim, name) in enumerate(zip(shape, axes)):
        if name is None:
            continue
        if name in _MODEL_NAMES and "model" not in where and model_n > 1 \
                and dim % model_n == 0:
            where["model"] = i
        elif name in _DATA_NAMES and "data" not in where and daxes \
                and dp > 1 and dim % dp == 0:
            where["data"] = i
    return tuple(Shard(where["model"]) if a == "model" and "model" in where
                 else Shard(where["data"]) if a != "model" and "data" in where
                 else Replicate() for a in sizes)


def _leaf_axes(shape: tuple, axes: Optional[tuple]) -> tuple:
    axes = tuple(axes) if axes else (None,) * len(shape)
    return (None,) * (len(shape) - len(axes)) + axes


class Abstract(NamedTuple):
    """A parameter's shape and dtype with its placements: what
    :func:`shard_params` makes of a ``meta`` tensor (the reference's
    ``ShapeDtypeStruct`` with a sharding)."""
    shape: tuple
    dtype: torch.dtype
    placements: tuple


def shard_params(mesh: Any, params: Any, axes: Mapping[str, tuple]):
    """Place parameters by their logical axes (``{name: axes}``).

    ``params`` is an ``nn.Module`` whose parameters are replaced in place by
    ``DTensor``s (returned; every rank holds the whole tensor and keeps its
    own shard, no collective) or ``{name: meta tensor}`` (a dict of
    :class:`Abstract`: the placements of shapes, over any mesh)."""
    if isinstance(params, torch.nn.Module):
        for full, p in list(params.named_parameters()):
            owner, _, name = full.rpartition(".")
            mod = params.get_submodule(owner) if owner else params
            placements = _spec_for(mesh, tuple(p.shape),
                                   _leaf_axes(p.shape, axes[full]))
            mod._parameters[name] = torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, placements,
                                  src_data_rank=None),
                requires_grad=p.requires_grad)
        return params
    out = {}
    for name, t in params.items():
        if t.device.type != "meta":
            raise TypeError(f"shard_params: {name} is on {t.device}; a dict "
                            f"takes meta tensors (place a module's "
                            f"parameters by passing the module)")
        out[name] = Abstract(tuple(t.shape), t.dtype, _spec_for(
            mesh, tuple(t.shape), _leaf_axes(t.shape, axes[name])))
    return out


def like(ref: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``full`` (the whole tensor, on every rank) placed as ``ref`` is: a
    ``DTensor`` of ``ref``'s mesh and placements, or ``full`` itself when
    ``ref`` is a plain tensor. No collective: each rank keeps its shard."""
    if not isinstance(ref, DTensor):
        return full
    return distribute_tensor(full.to(ref.device), ref.device_mesh,
                             ref.placements, src_data_rank=None)


def constrain(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    """Pin an activation's placements by logical names; no-op without an
    active mesh (and on a tensor that is not a ``DTensor``)."""
    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, _spec_for(mesh, tuple(x.shape),
                                          tuple(logical_axes)))


def contract(spec: str, x: torch.Tensor, w: torch.Tensor, parsed: tuple):
    """``einsum(spec, x, w)`` of ``DTensor``s, an LM projection (``parsed``:
    x's leading labels, the contracted ones, w's output ones; x = (lead...,
    k...), w = (k..., out...)), with its collectives written out: DTensor
    (torch 2.11) has no rule for einsum's fold of two sharded leading dims
    (a ("batch", "seq_tp") activation). The product runs on each rank's
    local shards (``local_map``) by these rules, mesh dimension by mesh
    dimension:

      * a data dimension: x keeps its rows' shard, w is gathered whole
        (the ZeRO-3 all-gather); w's gradient is a partial sum;
      * ``model`` with x sharded on a leading dim (the sequence): w is
        gathered whole, the output keeps x's shard, w's gradient is
        partial;
      * ``model`` with x sharded on a contracted dim: w is sharded on the
        same dim, the output is a partial sum (Megatron's row-parallel
        half);
      * ``model`` with x whole: w keeps its shard of an output dim (the
        output is sharded there, x's gradient partial) or is whole.
    """
    lead, contracted, _ = parsed
    nb, nk = len(lead), len(contracted)
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    if not isinstance(x, DTensor):
        x = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim,
                              src_data_rank=None)
    if not isinstance(w, DTensor):
        w = distribute_tensor(w, mesh, [Replicate()] * mesh.ndim,
                              src_data_rank=None)
    names = mesh.mesh_dim_names
    xs, ws, outs, gx, gw = [], [], [], [], []
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        dx = px.dim if isinstance(px, Shard) else None
        dw = pw.dim if isinstance(pw, Shard) else None
        if names[i] != "model" or (dx is not None and dx < nb):
            if dx is not None and dx >= nb:
                raise NotImplementedError(
                    f"{spec}: x shards contracted dim {dx} over "
                    f"{names[i]!r}")
            xs.append(px)
            ws.append(Replicate())
            outs.append(px)
            gx.append(px)
            gw.append(Partial() if dx is not None else Replicate())
        elif dx is not None or (dw is not None and dw < nk):
            k = dx - nb if dx is not None else dw
            xs.append(Shard(nb + k))
            ws.append(Shard(k))
            outs.append(Partial())
            gx.append(Shard(nb + k))
            gw.append(Shard(k))
        else:
            xs.append(Replicate())
            ws.append(pw)
            outs.append(Replicate() if dw is None else Shard(nb + dw - nk))
            gx.append(Replicate() if dw is None else Partial())
            gw.append(pw)
    xs, ws, outs, gx, gw = map(tuple, (xs, ws, outs, gx, gw))
    return local_map(lambda a, b: torch.einsum(spec, a, b),
                     out_placements=(outs,), in_placements=(xs, ws),
                     in_grad_placements=(gx, gw), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def lookup(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``w[idx]`` (an embedding's rows) of ``DTensor``s, its collectives
    written out: DTensor (torch 2.11) has no rule for the lookup's backward
    (``index_put`` into a vocab-sharded table). On each rank's shards
    (``local_map``): w is gathered whole over the data dimensions (its rows'
    gradient a partial sum there); over ``model`` a vocab shard looks up
    the ids it holds and writes zero for the others, so the rows are a
    partial sum over ``model`` and the table's gradient keeps the shard."""
    mesh = w.device_mesh
    if not isinstance(idx, DTensor):
        idx = distribute_tensor(idx, mesh, [Replicate()] * mesh.ndim,
                                src_data_rank=None)
    names = mesh.mesh_dim_names
    ws, ids, outs, gw = [], [], [], []
    vocab = None
    for i, (pw, pi) in enumerate(zip(w.placements, idx.placements)):
        if names[i] != "model":
            ws.append(Replicate())
            ids.append(pi)
            outs.append(pi)
            gw.append(Partial() if isinstance(pi, Shard) else Replicate())
        else:
            ids.append(Replicate())
            ws.append(pw)
            gw.append(pw)
            if isinstance(pw, Shard) and pw.dim == 0:
                vocab = i
                outs.append(Partial())
            else:
                outs.append(Shard(idx.ndim + pw.dim - 1)
                            if isinstance(pw, Shard) else Replicate())
    rows = -(-w.shape[0] // mesh.size(vocab)) if vocab is not None else 0
    first = rows * mesh.get_local_rank(vocab) if vocab is not None else 0

    def body(table, ids_local):
        if vocab is None:
            return table[ids_local]
        i = ids_local - first
        hit = (i >= 0) & (i < table.shape[0])
        got = table[i.clamp(0, table.shape[0] - 1)]
        zero = torch.zeros((), dtype=got.dtype, device=got.device)
        return torch.where(hit[..., None], got, zero)
    return local_map(body, out_placements=(tuple(outs),),
                     in_placements=(tuple(ws), tuple(ids)),
                     in_grad_placements=(tuple(gw), tuple(ids)),
                     device_mesh=mesh, redistribute_inputs=True)(w, idx)


_HOST_STAGED: list = []


def _group_backend(group_name: str) -> str:
    """The backend of the process group a functional collective names
    (``_resolve_process_group`` is private; torch 2.11 and 2.13 have it)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_backend(_resolve_process_group(group_name))


def _gather_as_is(inp: torch.Tensor, group_size: int,
                  group_name: str) -> torch.Tensor:
    """The all-gather on the tensor as it lies: the coalesced functional op
    of one tensor (the same gather, an op the override leaves alone)."""
    return torch.ops._c10d_functional.all_gather_into_tensor_coalesced(
        [inp], group_size, group_name)[0]


def _gather_on_host(inp: torch.Tensor, group_size: int,
                    group_name: str) -> torch.Tensor:
    """The all-gather of a host copy (the op itself: its CPU kernel is not
    overridden), waited for and copied back."""
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        inp.cpu(), group_size, group_name)
    return torch.ops._c10d_functional.wait_tensor(out).to(inp.device)


def _staged_gather(inp: torch.Tensor, group_size: int,
                   group_name: str) -> torch.Tensor:
    if _group_backend(group_name) == "gloo":
        return _gather_on_host(inp, group_size, group_name)
    return _gather_as_is(inp, group_size, group_name)


def stage_gathers_through_host() -> None:
    """Run ``_c10d_functional.all_gather_into_tensor`` on CUDA tensors of a
    gloo group as a gather of host copies (installed once a process).
    Torch 2.11's gloo segfaults in that op's wait on CUDA tensors, the one
    collective of DTensor's that it does not take (all_reduce,
    reduce_scatter, all_to_all and broadcast it runs on the card's tensors
    as they lie); a group of any other backend (NCCL) gathers the tensors
    as they lie. No compute moves to the host."""
    if _HOST_STAGED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _staged_gather, "CUDA")
    _HOST_STAGED.append(lib)


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
        # every rank has joined before any leaves: a rank whose ``fn``
        # returns at once would close its side of the group while a peer
        # still connects, and the peer would fail in its own init
        dist.barrier(**({"device_ids": [dev.index]} if backend == "nccl"
                        else {}))
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
