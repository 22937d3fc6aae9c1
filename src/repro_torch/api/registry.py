"""Assignment-backend registry (counterpart of ``repro.api.registry``).

Every assignment implementation is an :class:`AssignmentBackend` with
declared capabilities and one call signature

    backend(x, c, *, params=None, inj=None, bounds=None)
        -> (assign, min_dist, detected)

extended by ``(sums, counts)`` for one-pass backends and further by
``(new_bounds, prune_frac)`` for pruned ones, so the estimator
never branches on backend names. Capability mismatches are rejected here.

``python -m repro_torch.api.registry --markdown docs/backends_torch.md``
renders the registry as a capability matrix; ``--check PATH`` exits 1 when
the committed file is stale (0 when fresh, 2 on a usage error).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Optional

import torch

# Capability flags, in rendering order
_FLAG_COLUMNS = ("supports_ft", "takes_params", "takes_injection",
                 "fuses_update", "supports_batch", "supports_bounds",
                 "supports_int8")


class BackendCapabilityError(TypeError):
    """A backend was asked for a capability it does not declare."""


@dataclasses.dataclass(frozen=True)
class AssignmentBackend:
    """One cluster-assignment implementation plus its capability flags.

    supports_ft:     detects and corrects SDCs, counting them.
    takes_params:    accepts ``KernelParams`` and a prebuilt ``DataPlan``.
    takes_injection: accepts an in-kernel SEU injection descriptor.
    fuses_update:    one-pass backend returning ``(assign, min_dist,
                     detected, sums, counts)``.
    supports_batch:  many-problem backend: ``x`` is a (B, N, F) stack (or a
                     ``BatchPlan``), ``c`` (B, K, F), and every output
                     carries a leading B axis. Only ``BatchedKMeans`` drives
                     it; ``KMeans`` refuses it.
    supports_bounds: pruned backend: takes the carried ``bounds`` state
                     (``ops.BoundsState``) and returns the 7-tuple
                     ``(assign, min_dist, detected, sums, counts,
                     new_bounds, prune_frac)``. ``bounds=None`` (or a fresh
                     state from ``bounds_init``) computes every tile.
    supports_int8:   quantised-distance backend: ``x`` may be an
                     ``ops.QuantPlan``; bit-exact argmin against the f32
                     backends on quantisation-safe data.
    bounds_init:     for ``supports_bounds`` backends, ``(m, k, f, params,
                     *, device) -> state``, the fresh state of a fit's first
                     step.
    """

    name: str
    fn: Callable
    supports_ft: bool = False
    takes_params: bool = False
    takes_injection: bool = False
    fuses_update: bool = False
    supports_batch: bool = False
    supports_bounds: bool = False
    supports_int8: bool = False
    bounds_init: Optional[Callable] = None
    doc: str = ""

    @property
    def kernel_kind(self) -> str:
        """The kernel family whose tiles this backend uses: the int8
        kernel, the batched one-pass kernel, the pruned one-pass kernel, the
        assignment-only kernel, the one-pass kernel or the one-pass FT
        kernel."""
        if self.supports_int8:
            return "int8"
        if self.supports_batch:
            return "batched"
        if self.supports_bounds:
            return "pruned"
        if self.fuses_update:
            return "lloyd_ft" if self.supports_ft else "lloyd"
        return "assign"

    @property
    def protected_intervals(self) -> int:
        """Independently verified SEU intervals per step (§II-A: at most
        one error per interval): the distance GEMM and, for one-pass FT
        backends, the update epilogue."""
        if not self.takes_injection:
            return 0
        return 2 if self.fuses_update else 1

    def __call__(self, x: Any, c: torch.Tensor, *, params: Any = None,
                 inj: Optional[torch.Tensor] = None,
                 bounds: Any = None) -> Any:
        if inj is not None and not self.takes_injection:
            raise BackendCapabilityError(
                f"backend {self.name!r} does not take in-kernel injections "
                f"(takes_injection=False)")
        if params is not None and not self.takes_params:
            raise BackendCapabilityError(
                f"backend {self.name!r} does not take kernel parameters "
                f"(takes_params=False)")
        if bounds is not None and not self.supports_bounds:
            raise BackendCapabilityError(
                f"backend {self.name!r} does not carry pruning bounds "
                f"(supports_bounds=False); use a pruned backend or drop "
                f"the bounds state")
        if self.supports_bounds:
            return self.fn(x, c, params, bounds=bounds)
        if self.takes_injection:
            return self.fn(x, c, params, inj=inj)
        if self.takes_params:
            return self.fn(x, c, params)
        return self.fn(x, c)


# name -> backend, filled once when repro_torch.core.assignment is imported
_REGISTRY: dict[str, AssignmentBackend] = {}


def register_backend(backend: AssignmentBackend) -> AssignmentBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> AssignmentBackend:
    _ensure_builtin_backends()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown assignment backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_backends() -> dict[str, AssignmentBackend]:
    """Name -> backend, a snapshot of the registry."""
    _ensure_builtin_backends()
    return dict(_REGISTRY)


def _ensure_builtin_backends() -> None:
    from repro_torch.core import assignment  # noqa: F401  (registers)


# ---------------------------------------------------------------------------
# Capability matrix: ``python -m repro_torch.api.registry --markdown PATH``
# ---------------------------------------------------------------------------

EXIT_OK, EXIT_STALE, EXIT_USAGE = 0, 1, 2

_MD_HEADER = """\
# Backend capability matrix of the PyTorch / CUDA port

<!-- AUTO-GENERATED by `python -m repro_torch.api.registry --markdown docs/backends_torch.md`.
     Do not edit by hand: tests/test_torch_autotune.py fails when this file is stale. -->

Every cluster-assignment implementation of `repro_torch` registers as an
`AssignmentBackend` with declared capabilities and the uniform call
signature `backend(x, c, *, params=None, inj=None, bounds=None)`; estimators
select one via `FaultPolicy.resolve_backend` or `get_backend(name)` and
never branch on backend names. The `takes_params` backends launch the CUDA
kernels of `src/repro_torch/csrc/` on the card and their plain PyTorch
versions on the CPU. [backends.md](backends.md) is the JAX package's
matrix.
"""


def render_markdown() -> str:
    """The registry as a markdown document (capability flags, autotune
    kernel kind, protected injection intervals, one-line doc)."""
    backends = list_backends()
    short = {"supports_ft": "ft", "takes_params": "params",
             "takes_injection": "inject", "fuses_update": "one-pass",
             "supports_batch": "batch", "supports_bounds": "pruned",
             "supports_int8": "int8"}
    lines = [_MD_HEADER]
    lines.append("| backend | " + " | ".join(short[c] for c in _FLAG_COLUMNS)
                 + " | kernel kind | protected intervals | description |")
    lines.append("|---|" + "---|" * (len(_FLAG_COLUMNS) + 3))
    for name in sorted(backends):
        b = backends[name]
        flags = " | ".join("✓" if getattr(b, c) else "·"
                           for c in _FLAG_COLUMNS)
        lines.append(f"| `{name}` | {flags} | `{b.kernel_kind}` | "
                     f"{b.protected_intervals} | {b.doc} |")
    lines.append("")
    lines.append("Flag legend: **ft** = detects/corrects SDCs "
                 "(`supports_ft`); **params** = accepts `KernelParams` "
                 "tiles and `DataPlan`/`BatchPlan` inputs (`takes_params`); "
                 "**inject** = accepts an in-kernel SEU descriptor "
                 "(`takes_injection`); **one-pass** = returns the extended "
                 "`(assign, min_dist, detected, sums, counts)` tuple "
                 "(`fuses_update`); **batch** = operates on (B, N, F) "
                 "problem stacks (`supports_batch`); **pruned** = carries "
                 "triangle-inequality bounds between iterations and "
                 "returns the 7-tuple extended by `(new_bounds, "
                 "prune_frac)` (`supports_bounds`); **int8** = runs the "
                 "distance product on per-row int8-quantised operands and "
                 "accepts `QuantPlan` inputs (`supports_int8`). "
                 "*Kernel kind* is the autotune table the backend's tiles "
                 "come from (`repro_torch.api.cache.AutotuneCache`); "
                 "*protected intervals* counts the independently verified "
                 "SEU intervals one step exposes to an injection campaign.")
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    """CLI: render (or check the freshness of) the capability matrix.
    Exit codes: 0 clean, 1 stale file, 2 usage error (argparse's)."""
    import argparse

    # ``python -m repro_torch.api.registry`` runs this file as __main__, a
    # second module instance with an empty _REGISTRY, while the builtin
    # backends register into the canonical module: render through that one
    from repro_torch.api import registry as canonical
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api.registry",
        description="render the port's backend capability matrix as "
                    "markdown")
    ap.add_argument("--markdown", nargs="?", const="-", metavar="PATH",
                    help="write the matrix to PATH (default: stdout)")
    ap.add_argument("--check", metavar="PATH",
                    help=f"exit {EXIT_STALE} if PATH differs from a fresh "
                         f"render")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return EXIT_OK if e.code == 0 else EXIT_USAGE
    rendered = canonical.render_markdown()
    if args.check:
        try:
            with open(args.check, encoding="utf-8") as fh:
                committed: Optional[str] = fh.read()
        except FileNotFoundError:
            committed = None
        if committed != rendered:
            print(f"{args.check} is stale; regenerate with `python -m "
                  f"repro_torch.api.registry --markdown {args.check}`",
                  file=sys.stderr)
            return EXIT_STALE
        print(f"{args.check} is up to date")
        return EXIT_OK
    if args.markdown in (None, "-"):
        print(rendered, end="")
    else:
        with open(args.markdown, "w", encoding="utf-8") as fh:
            fh.write(rendered)
        print(f"wrote {args.markdown}")
    return EXIT_OK


if __name__ == "__main__":
    raise SystemExit(main())
