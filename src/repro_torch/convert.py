"""Fitted-state interchange with the reference package.

``repro.api.KMeans.get_state()`` and ``repro_torch.api.KMeans.get_state()``
both return flat dicts of plain types and numpy arrays with the same keys,
but for three: the port adds ``config["device"]``, and it has no
``fault["worker_loss"]`` (whole-worker loss belongs to the distributed
slice) and no ``injection["bit_low"/"bit_high"]`` (no draw reads them).
Going to the reference, these get the reference's defaults.
``config["params"]`` keeps its meaning in both, because ``KernelParams``
names the same tile, and ``config["compute_dtype"]`` ("float32" or "int8")
passes through. The reference's host-only single-problem backends become
the port's kernel backends, whose plain versions are the port's CPU path:
``int8_xla`` -> ``int8``, ``lloyd_pruned_xla`` -> ``lloyd_pruned``. Pruning
bounds are never part of a state (every fit starts from fresh ones). A model
fitted by one package predicts the same labels after loading into the
other.

Batched states (``BatchedKMeans.get_state()``) have the same keys in both
packages but for ``config["device"]``; the reference's host-only backend
``lloyd_batched_xla`` becomes the port's ``lloyd_batched`` (its plain
version is the port's CPU path), and every other name passes through.
"""
from __future__ import annotations

import copy

import numpy as np

_REF_WORKER_LOSS = "fail"
_REF_BACKENDS = {"int8_xla": "int8", "lloyd_pruned_xla": "lloyd_pruned"}
_REF_BITS = {"bit_low": 20, "bit_high": 30}


def _arrays_f32(state: dict) -> dict:
    out = copy.deepcopy({k: v for k, v in state.items()
                         if k not in ("cluster_centers", "counts")})
    out["cluster_centers"] = np.asarray(state["cluster_centers"], np.float32)
    counts = state.get("counts")
    out["counts"] = None if counts is None else np.asarray(counts, np.float32)
    return out


def from_reference_state(state: dict) -> dict:
    """Reference ``get_state()`` dict -> the port's (device left to
    ``KMeans.from_state``, "cuda" unless it is given). A state whose policy
    shrinks the mesh on a worker loss raises: that needs the distributed
    slice."""
    out = _arrays_f32(state)
    cfg = out["config"]
    cfg["device"] = None
    cfg["backend"] = _REF_BACKENDS.get(cfg["backend"], cfg["backend"])
    fault = cfg["fault"]
    if fault.pop("worker_loss", _REF_WORKER_LOSS) != _REF_WORKER_LOSS:
        raise NotImplementedError(
            "FaultPolicy(worker_loss='shrink') (elastic checkpoint-restart) "
            "is not ported yet; it comes with the distributed slice (ROADMAP "
            "Queue 1, item 10)")
    if fault.get("injection") is not None:
        for key in _REF_BITS:
            fault["injection"].pop(key, None)
    return out


def to_reference_state(state: dict) -> dict:
    """Port ``get_state()`` dict -> the reference's."""
    out = _arrays_f32(state)
    cfg = out["config"]
    cfg.pop("device", None)
    cfg["fault"]["worker_loss"] = _REF_WORKER_LOSS
    if cfg["fault"].get("injection") is not None:
        cfg["fault"]["injection"].update(_REF_BITS)
    return out


_REF_BATCHED_BACKENDS = {"lloyd_batched_xla": "lloyd_batched"}


def _batched_arrays(state: dict) -> dict:
    out = copy.deepcopy({k: v for k, v in state.items()
                         if k not in ("cluster_centers", "n_iter", "inertia")})
    out["cluster_centers"] = np.asarray(state["cluster_centers"], np.float32)
    out["n_iter"] = np.asarray(state["n_iter"])
    inertia = state.get("inertia")
    out["inertia"] = None if inertia is None else np.asarray(inertia)
    return out


def from_reference_batched_state(state: dict) -> dict:
    """Reference ``BatchedKMeans.get_state()`` dict -> the port's (device
    left to ``BatchedKMeans.from_state``, "cuda" unless it is given)."""
    out = _batched_arrays(state)
    cfg = out["config"]
    cfg["device"] = None
    cfg["backend"] = _REF_BATCHED_BACKENDS.get(cfg["backend"],
                                               cfg["backend"])
    return out


def to_reference_batched_state(state: dict) -> dict:
    """Port ``BatchedKMeans.get_state()`` dict -> the reference's."""
    out = _batched_arrays(state)
    out["config"].pop("device", None)
    return out
