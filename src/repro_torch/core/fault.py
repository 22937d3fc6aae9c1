"""SEU injection campaign draws (paper §II-A fault model), the counterpart
of the campaign part of ``repro.core.fault``.

Injections target compute results (the distance accumulator, the update
product), never stored inputs. Every draw comes from a numpy ``Generator``
in the reference's order, so one seed plants the same (tile, row, col,
delta) in both packages. Descriptors are int32 CPU tensors; the caller
moves them to the device once per chunk of iterations.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import distance_argmin_ft as _daft
from repro_torch.kernels import lloyd_step_ft as _llft


def planned_injections(rng, rate: float, cap: int) -> int:
    """Per-step injection count: a Bernoulli draw for ``rate <= 1``, else
    ``floor(rate)`` plus a Bernoulli on the fraction, clipped at ``cap``
    (the step's independently verified intervals)."""
    if rate <= 0 or cap <= 0:
        return 0
    if rate <= 1.0:
        return int(rng.uniform() < rate)
    whole = int(rate)
    n = whole + int(rng.uniform() < (rate - whole))
    return min(n, cap)


def _delta(rng) -> float:
    # exponent-bit flip magnitudes 2^18..2^23, either sign
    return float(rng.choice([-1.0, 1.0]) * 2.0 ** rng.integers(18, 24))


def draw_step_injection(rng, m: int, k: int, f: int, params, *,
                        rate: float,
                        targets: tuple[str, ...] = ("distance",),
                        kind: str = "assign") -> torch.Tensor:
    """One Lloyd step's in-kernel SEU descriptor for a campaign; ``kind``
    ``"lloyd_ft"`` selects the dual-slot layout, anything else the 8-word
    distance descriptor. ``params`` must already be clamped."""
    if kind != "lloyd_ft":
        if planned_injections(rng, rate, 1):
            return draw_tile_injection(rng, m, k, f, params)
        return _daft.no_injection()
    n = planned_injections(rng, rate, len(targets))
    chosen = list(rng.choice(len(targets), size=n, replace=False))
    distance = update = None
    mp = -(-m // params.block_m)
    if any(targets[i] == "distance" for i in chosen):
        kp = -(-k // params.block_k)
        fp = -(-f // params.block_f)
        delta = _delta(rng)
        distance = (int(rng.integers(mp)), int(rng.integers(kp)),
                    int(rng.integers(fp)), int(rng.integers(params.block_m)),
                    int(rng.integers(params.block_k)), delta)
    if any(targets[i] == "update" for i in chosen):
        delta = _delta(rng)
        update = (int(rng.integers(mp)), int(rng.integers(k)),
                  int(rng.integers(f)), delta)
    return _llft.make_injection(distance=distance, update=update)


def no_step_injection(kind: str = "assign") -> torch.Tensor:
    """The disarmed descriptor in the format ``kind``'s kernel expects."""
    if kind == "lloyd_ft":
        return _llft.no_injection()
    return _daft.no_injection()


def draw_tile_injection(rng, m: int, k: int, f: int,
                        params) -> torch.Tensor:
    """One SEU for the assignment-only FT kernel: a random tile of the
    (m, k, f) grid, a random element of it, a bit-flip-sized delta."""
    mp = -(-m // params.block_m)
    kp = -(-k // params.block_k)
    fp = -(-f // params.block_f)
    delta = _delta(rng)
    return _daft.make_injection(int(rng.integers(mp)), int(rng.integers(kp)),
                                int(rng.integers(fp)),
                                int(rng.integers(params.block_m)),
                                int(rng.integers(params.block_k)), delta)
