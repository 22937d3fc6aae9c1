"""Injectable kernel-selection table (counterpart of ``repro.api.cache``).

:class:`AutotuneCache` is the table of per-shape tile winners the
estimators consult (paper §III-B), as an object passed per estimator
(``KMeans(..., autotune=cache)``): two estimators can run with different
tables in one process, and a test gets a fresh one. No environment variable
names a table; the default cache's file is the port's own
``repro_torch/core/autotune_table.json`` (never the reference's TPU
winners), and the repository commits none: a missing file is an empty
table, and every miss is the model's winner.

The file format is the reference's schema 7, so the key discipline is the
same: entries are keyed by kernel kind, compute dtype and batch bucket,
then shape bucket, and each holds ``[variant, block_m, block_k,
block_f]``::

    {"schema": 7,
     "kinds": {"assign/float32/b0":  {"20-9-7": ["generic", 128, 128, 32]},
               "batched/bfloat16/b5": {"16-8-4": ["batched", 128, 128, 32]},
               "serve/float32/b0":   {"11-9-7": ["generic", 64, 128, 32],
                                      "ladder:9-7": [120.0, 128, 512, 2048]}}}

A winner never crosses a kind, a dtype or a batch bucket. ``ladder:<log2
K>-<log2 F>`` pseudo-entries under the serve kind hold a tuned serving plan,
``[window_us, bucket, ...]`` (``repro_torch.serve.tuning.plan_ladder``).
Files of schema 4 to 7 share this entry format and load as they are.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Iterable, Optional

from repro_torch.kernels.ops import KernelParams

_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "core", "autotune_table.json")

SCHEMA_VERSION = 7
_MIN_SCHEMA = 4


def shape_bucket(m: int, k: int, f: int) -> str:
    """log2 bucket per dimension: shapes in a bucket share a winner."""
    b = lambda v: int(math.log2(max(v, 1)))  # noqa: E731
    return f"{b(m)}-{b(k)}-{b(f)}"


def batch_bucket(batch: int) -> str:
    """log2 bucket of the problem count B (``b0`` = one problem)."""
    return f"b{int(math.log2(max(batch, 1)))}"


def _dtype_name(dtype: Any) -> str:
    from repro_torch.core.autotune import as_dtype
    return str(as_dtype(dtype)).replace("torch.", "")


def _key(kind: str, dtype: Any, batch: int = 1) -> str:
    return f"{kind}/{_dtype_name(dtype)}/{batch_bucket(batch)}"


class AutotuneCache:
    """Kind-, dtype-, batch- and shape-bucketed winner table, backed lazily
    by a JSON file. ``path=None`` keeps it in memory; a path is read at the
    first lookup and written by :meth:`save`."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._table: Optional[dict[str, dict[str, list]]] = None
        self._computed: dict[tuple, tuple[str, KernelParams]] = {}
        self._lock = threading.RLock()   # build() holds it across put/save

    @classmethod
    def default(cls) -> "AutotuneCache":
        """A cache on the port's packaged table location."""
        return cls(_DEFAULT_PATH)

    # -- table I/O ---------------------------------------------------------

    def _load(self) -> dict[str, dict[str, list]]:
        if self._table is None:
            table: dict[str, dict[str, list]] = {}
            if self.path and os.path.exists(self.path):
                with open(self.path) as fh:
                    raw = json.load(fh)
                schema = raw.get("schema") if isinstance(raw, dict) else None
                if not isinstance(schema, int) or not (
                        _MIN_SCHEMA <= schema <= SCHEMA_VERSION):
                    raise ValueError(
                        f"{self.path}: autotune table schema {schema!r}; "
                        f"this cache reads schemas {_MIN_SCHEMA}-"
                        f"{SCHEMA_VERSION}")
                table = {k: dict(v) for k, v in raw["kinds"].items()}
            self._table = table
        return self._table

    def save(self, path: Optional[str] = None) -> str:
        """Write the table (current schema, sorted keys) and return the
        path."""
        path = path or self.path
        if not path:
            raise ValueError("AutotuneCache has no backing path to save to")
        with self._lock:
            kinds = self._load()   # before open(..., "w") truncates the file
            with open(path, "w") as fh:
                json.dump({"schema": SCHEMA_VERSION, "kinds": kinds}, fh,
                          indent=1, sort_keys=True)
        return path

    # -- lookup / update ---------------------------------------------------

    def put(self, m: int, k: int, f: int, params: KernelParams, *,
            kind: str = "assign", dtype: Any = None,
            variant: str = "generic", batch: int = 1) -> None:
        with self._lock:
            self._load().setdefault(_key(kind, dtype, batch), {})[
                shape_bucket(m, k, f)] = [
                variant, params.block_m, params.block_k, params.block_f]

    def lookup(self, m: int, k: int, f: int, *, kind: str = "assign",
               dtype: Any = None, batch: int = 1
               ) -> tuple[str, KernelParams]:
        """The stored ``(variant, params)`` winner of (kind, dtype, batch
        bucket, shape bucket), else the model's winner at this shape
        (``repro_torch.core.autotune.select_params``), memoised per
        instance. An entry of another kind, dtype or batch bucket is never
        returned."""
        with self._lock:
            hit = self._load().get(_key(kind, dtype, batch), {}).get(
                shape_bucket(m, k, f))
            if hit is not None:
                variant, bm, bk, bf = hit
                return variant, KernelParams(bm, bk, bf)
            key = (m, k, f, kind, _dtype_name(dtype), batch_bucket(batch))
            if key not in self._computed:
                from repro_torch.core.autotune import select_params
                self._computed[key] = select_params(
                    m, k, f, mode="model", kind=kind, dtype=dtype,
                    batch=batch)
            return self._computed[key]

    # -- serving ladder (schema-7 pseudo-entries) --------------------------

    @staticmethod
    def _ladder_bucket(k: int, f: int) -> str:
        """Ladder entries are per model shape (K, F); the ``ladder:`` prefix
        keeps them out of the shape-bucket namespace."""
        b = lambda v: int(math.log2(max(v, 1)))  # noqa: E731
        return f"ladder:{b(k)}-{b(f)}"

    def put_ladder(self, k: int, f: int, *, buckets: Iterable[int],
                   window_us: float, dtype: Any = None) -> None:
        """Record a tuned serving plan (row-bucket ladder and micro-batch
        window in us) for a model shape."""
        entry = [float(window_us), *(int(b) for b in buckets)]
        with self._lock:
            self._load().setdefault(_key("serve", dtype), {})[
                self._ladder_bucket(k, f)] = entry

    def lookup_ladder(self, k: int, f: int, *, dtype: Any = None
                      ) -> Optional[tuple[tuple[int, ...], float]]:
        """The stored ``(buckets, window_us)`` serving plan of the model
        shape, or None (no computed fallback: planning walks every ladder,
        so the serving layer decides when to pay for it)."""
        with self._lock:
            hit = self._load().get(_key("serve", dtype), {}).get(
                self._ladder_bucket(k, f))
            if hit is None:
                return None
            window_us, *buckets = hit
            return tuple(int(b) for b in buckets), float(window_us)

    def build(self, shapes: Iterable[tuple[int, int, int]], *,
              mode: str = "model", dtype: Any = None,
              kinds: Iterable[str] = ("assign",),
              batch: int = 1) -> dict[str, dict[str, list]]:
        """Select the winner of every shape for each kind, record them and
        save when file-backed. Returns the table."""
        from repro_torch.core.autotune import select_params
        with self._lock:
            for kind in kinds:
                for (m, k, f) in shapes:
                    variant, p = select_params(m, k, f, mode=mode,
                                               dtype=dtype, kind=kind,
                                               batch=batch)
                    self.put(m, k, f, p, kind=kind, dtype=dtype,
                             variant=variant, batch=batch)
            if self.path:
                self.save()
            return {k: dict(v) for k, v in self._load().items()}


_default_cache: Optional[AutotuneCache] = None
_default_lock = threading.Lock()


def default_cache() -> AutotuneCache:
    """The process's shared cache, for estimators given none."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = AutotuneCache.default()
        return _default_cache


__all__ = ["AutotuneCache", "SCHEMA_VERSION", "batch_bucket", "default_cache",
           "shape_bucket"]
