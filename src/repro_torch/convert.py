"""Fitted-state interchange with the reference package.

``repro.api.KMeans.get_state()`` and ``repro_torch.api.KMeans.get_state()``
both return flat dicts of plain types and numpy arrays with the same keys,
but for three: the port adds ``config["device"]``, and it has no
``fault["worker_loss"]`` (whole-worker loss belongs to the distributed
slice) and no ``injection["bit_low"/"bit_high"]`` (no draw reads them).
Going to the reference, these get the reference's defaults.
``config["params"]`` keeps its meaning in both, because ``KernelParams``
names the same tile, and ``config["compute_dtype"]`` ("float32",
"bfloat16", "float16" or "int8") passes through in both directions: a model
fitted in bf16 or fp16 by one package loads into the other at that dtype.
The reference's host-only single-problem backends become the port's kernel
backends, whose plain versions are the port's CPU path:
``int8_xla`` -> ``int8``, ``lloyd_pruned_xla`` -> ``lloyd_pruned``,
``lloyd_xla`` -> ``lloyd``, ``lloyd_ft_xla`` -> ``lloyd_ft``; every other
name (``naive``, ``gemm``, ``gemm_fused`` and the kernel backends) passes
through, the port registering each under the same name. Pruning
bounds are never part of a state (every fit starts from fresh ones). A model
fitted by one package predicts the same labels after loading into the
other.

Batched states (``BatchedKMeans.get_state()``) have the same keys in both
packages but for ``config["device"]``; the reference's host-only backend
``lloyd_batched_xla`` becomes the port's ``lloyd_batched`` (its plain
version is the port's CPU path), and every other name passes through.

Service states (``KMeansService.get_state()``) have the same keys in both
packages: the store's codebooks (f32 numpy arrays by version), the serving
config (backend, K, F, buckets, dtype name, window) and the wrapped
estimator's state. :func:`from_reference_service_state` maps the config's
backend name and the estimator state as above, so a reference service's
state serves from the port with the reference's labels;
:func:`to_reference_service_state` goes the other way.

LM weights and caches: the reference's ``LM.init`` tree stacks full periods
of the layer pattern (``params["periods"][slot][...]`` with a leading
``n_periods`` dimension, remainder layers in ``params["tail"]``), and so do
its prefill caches. :func:`lm_params_from_reference` and
:func:`lm_caches_from_reference` unstack both into the port's per-layer
``LM.state_dict()`` and cache list, from numpy arrays (bf16 arrays as
``ml_dtypes.bfloat16``, which numpy reports as ``bfloat16``).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

_REF_WORKER_LOSS = "fail"
_REF_BACKENDS = {"int8_xla": "int8", "lloyd_pruned_xla": "lloyd_pruned",
                 "lloyd_xla": "lloyd", "lloyd_ft_xla": "lloyd_ft"}
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
            "is not ported yet; it comes with the port of the distributed "
            "fit and elastic checkpoint-restart (torch.distributed meshes)")
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


def _service_state(state: dict, backend_map: dict, estimator) -> dict:
    out = copy.deepcopy({k: v for k, v in state.items()
                         if k not in ("store", "estimator")})
    store = state["store"]
    out["store"] = {"keep": store["keep"], "current": store["current"],
                    "codebooks": {str(v): np.asarray(c, np.float32)
                                  for v, c in store["codebooks"].items()}}
    cfg = out["config"]
    cfg["backend"] = backend_map.get(cfg["backend"], cfg["backend"])
    est = state.get("estimator")
    out["estimator"] = None if est is None else estimator(est)
    return out


def from_reference_service_state(state: dict) -> dict:
    """Reference ``KMeansService.get_state()`` dict -> the port's (device
    left to ``KMeansService.from_state``)."""
    return _service_state(state, _REF_BACKENDS, from_reference_state)


def to_reference_service_state(state: dict) -> dict:
    """Port ``KMeansService.get_state()`` dict -> the reference's. The
    port's kernel backends keep their names, which the reference also
    registers."""
    return _service_state(state, {}, to_reference_state)


def _tensor(a) -> torch.Tensor:
    """numpy array -> CPU tensor (a copy); bf16 arrays keep their bits."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _layer_trees(tree: dict, cfg) -> list:
    """Per-layer subtrees of a reference tree stacked by period: layer
    t * period + j is ``tree["periods"][j]`` at index t, the remainder
    ``tree["tail"]``."""
    period = len(cfg.layer_pattern)
    n_periods = cfg.num_layers // period if cfg.scan_layers else 0
    out = []
    for i in range(n_periods * period):
        t, j = divmod(i, period)
        out.append(_map(tree["periods"][j], lambda a, t=t: a[t]))
    out.extend(tree.get("tail", []))
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    return fn(tree)


def lm_params_from_reference(params: dict, cfg) -> dict:
    """The reference ``LM.init`` params (numpy leaves) -> the port's
    ``LM.state_dict()`` for ``cfg`` (CPU tensors; ``load_state_dict`` copies
    them to the model's device)."""
    sd = {f"embed.{k}": _tensor(v) for k, v in params["embed"].items()}
    sd["final_norm.scale"] = _tensor(params["final_norm"]["scale"])
    for i, layer in enumerate(_layer_trees(params, cfg)):
        for block, names in layer.items():
            for name, a in names.items():
                sd[f"layers.{i}.{block}.{name}"] = _tensor(a)
    return sd


def lm_caches_from_reference(caches: dict, cfg, device=None) -> list:
    """The reference's prefill caches (numpy leaves, ``KVCache``
    namedtuples) -> the port's per-layer cache list on ``device``."""
    from repro_torch.models.attention import KVCache
    out = []
    for layer in _layer_trees(caches, cfg):
        kv = layer["kv"]
        out.append({"kv": KVCache(*(_tensor(a).to(device) for a in kv))})
    return out
