"""Checkpoint / restart for fail-stop faults, on one process or a group of
ranks.

The port of ``repro.ft.checkpoint.Checkpointer`` for the train loop:

  * asynchronous: the device-to-host copy runs on the caller's thread,
    serialisation and fsync on a background writer, so the loop does not
    wait on storage (``wait`` blocks until every queued snapshot is
    durable and raises a writer's error);
  * atomic: each snapshot goes to a temporary file, is fsynced and renamed,
    so a crash mid-write never corrupts the newest valid snapshot;
  * self-describing: a manifest (step, every key's shape and dtype) is
    written beside the snapshots; the newest ``keep`` snapshots are kept.

A state is a nested dict of tensors (or numpy arrays); it is stored flat,
keyed by the "/"-joined path. bf16 tensors are stored widened to f32 (exact;
numpy has no bf16) with their dtype in the manifest, and ``restore``
returns flat numpy arrays for the caller to cast back, as the reference's
launcher casts each to its parameter's dtype. The reference's multi-host
``local_only`` save is not ported: in a distributed fit the lowest live
rank writes every snapshot (``repro_torch.dist.kmeans_dist``).

On a mesh (``group``: the ranks that save together) every rank calls
``save`` and ``wait``: a ``DTensor`` leaf is gathered whole (a collective,
so the ranks save the same keys in the same order), the group's first rank
writes, and ``wait`` returns on every rank once its snapshots are durable.
A snapshot holds whole tensors whatever the mesh, so one written on a mesh
restores on one device and the reverse (``repro_torch.dist.sharding.like``
places a restored tensor as its parameter is placed).
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def flatten(state: Any, prefix: str = "") -> dict:
    """{"/"-joined path: leaf} of a nested dict."""
    if isinstance(state, dict):
        out = {}
        for key, value in state.items():
            out.update(flatten(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: state}


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array (bf16 widened to f32) and its dtype; a
    ``DTensor`` gathered whole first."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True, group: Any = None):
        self.directory = directory
        self.keep = keep
        self.group = group
        self.writes = group is None or dist.get_rank(group) == 0
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_write
        self._worker: Optional[threading.Thread] = None
        self._errors: list[BaseException] = []
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- public API ---------------------------------------------------------

    def save(self, step: int, state: Any) -> None:
        """Snapshot ``state`` (a nested dict of tensors) at ``step``."""
        arrays, dtypes = {}, {}
        for key, leaf in flatten(state).items():
            arrays[key], dtypes[key] = _host(leaf)
        if not self.writes:
            return
        payload = (step, arrays, dtypes)
        if self._async:
            self._q.put(payload)
        else:
            self._write(payload)

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The newest (or the given) snapshot as {key: np.ndarray} plus
        ``"_step"``. A snapshot that does not load is skipped for the next
        older one; a pinned ``step`` is never substituted (it raises)."""
        self.wait()
        steps = self.available_steps()
        if not steps:
            return None
        candidates = [step] if step is not None else list(reversed(steps))
        for s in candidates:
            try:
                with np.load(self._path(s)) as data:
                    out = {k: data[k] for k in data.files}
            except Exception:
                if step is not None:
                    raise
                continue
            out["_step"] = s
            return out
        return None

    def available_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".npz"):
                out.append(int(name[5:-4]))
        return sorted(out)

    def wait(self) -> None:
        """Block until all queued snapshots are durable (on a group: the
        writing rank's, on every rank)."""
        if self._async:
            self._q.join()
        if self.group is not None:
            dist.barrier(group=self.group)
        if self._errors:
            raise self._errors[0]

    # -- internals ----------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def _write(self, payload) -> None:
        step, arrays, dtypes = payload
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._path(step))
        manifest = {
            "step": step,
            "keys": {k: [list(v.shape), dtypes[k]] for k, v in arrays.items()},
            "time": time.time(),
        }
        mtmp = os.path.join(self.directory, "manifest.json.tmp")
        with open(mtmp, "w") as fh:
            json.dump(manifest, fh)
        os.replace(mtmp, os.path.join(self.directory, "manifest.json"))
        self._gc()

    def _gc(self) -> None:
        steps = self.available_steps()
        for old in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(old))
            except OSError:
                pass

    def _drain(self) -> None:
        while True:
            payload = self._q.get()
            try:
                self._write(payload)
            except BaseException as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()
