"""SEU fault injection (paper §II-A fault model), the counterpart of
``repro.core.fault``.

Injections target compute results (the distance accumulator, the update
product), never stored inputs. Two kinds live here:

* the bit-flip harness on a materialised tensor (:class:`FaultConfig`,
  :func:`flip_bit`, :func:`inject`, :func:`inject_delta`), which
  ``ft_gemm.ft_matmul`` consumes. Its draws come from an explicit
  ``torch.Generator`` on the tensor's device in place of a ``jax.random``
  key, so they cannot reproduce the reference's samples; :func:`flip_bit`
  itself is deterministic and bit for bit the reference's;
* campaign draws for the in-kernel descriptors. Every draw comes from a
  numpy ``Generator`` in the reference's order, so one seed plants the
  same (tile, row, col, delta) in both packages. Descriptors are int32 CPU
  tensors; the caller moves them to the device once per chunk of
  iterations.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import distance_argmin_ft as _daft
from repro_torch.kernels import lloyd_step_ft as _llft


_BITS_OF = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.bfloat16: torch.int16}


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """An injection campaign on a materialised tensor: ``rate`` expected
    flips per call (a Bernoulli draw, capped at 1), one bit in
    ``[bit_low, bit_high]`` (inclusive; the defaults reach high-mantissa and
    exponent bits, the detectable range), ``seed`` for callers that build
    their own generator."""

    rate: float = 1.0
    bit_low: int = 20
    bit_high: int = 30
    seed: int = 0

    def enabled(self) -> bool:
        return self.rate > 0


def flip_bit(x: torch.Tensor, idx, bit) -> torch.Tensor:
    """A copy of ``x`` with ``bit`` of flat element ``idx`` flipped. ``idx``
    and ``bit`` are ints or 0-d integer tensors on ``x``'s device, so a
    draw on the card is never read on the host."""
    bits_t = _BITS_OF[x.dtype]
    flat = x.reshape(-1).clone()
    bits = flat.view(bits_t)
    pos = torch.as_tensor(idx, device=x.device).long().view(1)
    one = torch.ones((), dtype=bits_t, device=x.device)
    mask = one << torch.as_tensor(bit, device=x.device).to(bits_t)
    bits.index_put_((pos,), bits[pos] ^ mask)
    return flat.view(x.shape)


def inject(gen: torch.Generator, x: torch.Tensor,
           cfg: FaultConfig) -> torch.Tensor:
    """At most one bit flip in ``x``, drawn from ``gen`` (on ``x``'s
    device): fire with probability ``min(rate, 1)``, a uniform flat index,
    a uniform bit in ``[bit_low, bit_high]``. Nothing is read on the
    host."""
    if not cfg.enabled():
        return x
    dev = x.device
    fire = torch.rand((), generator=gen, device=dev) < min(cfg.rate, 1.0)
    idx = torch.randint(0, x.numel(), (), generator=gen, device=dev)
    bit = torch.randint(cfg.bit_low, cfg.bit_high + 1, (), generator=gen,
                        device=dev)
    return torch.where(fire, flip_bit(x, idx, bit), x)


def inject_delta(gen: torch.Generator, x: torch.Tensor,
                 cfg: FaultConfig) -> torch.Tensor:
    """:func:`inject` as an additive tensor: zero but (possibly) one element,
    so ``x + inject_delta(...)`` is the corrupted tensor."""
    return inject(gen, x, cfg) - x


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
