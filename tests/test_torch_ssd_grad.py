"""The SSD chunk's gradient where the decay's exponent passes f32's range,
on the CPU.

``models.ssm._ssd_chunk`` forms M[t, s] = C_t . B_s exp(cs_t - cs_s) dt_s
for s <= t, cs the running sum of dt A (A < 0). The reference
(``repro.models.ssm._ssd_chunk``) takes exp over the whole (t, s) square
and masks the product after it; for s > t the exponent is positive, and
over a chunk of steps with a large dt |A| it passes f32's range: exp gives
inf, and inf times the mask's zero gradient is NaN in the backward.
mamba2-1.3b's first training step at 4096 tokens on the card had every
gradient non-finite that way. The port masks the exponent before exp: the
kept entries are the same exp of the same value, so its forward and its
gradient are the reference's wherever the reference's are finite (held
here at ``RTOL`` of the largest, f32 sums in other orders), and finite
where the reference's are not (held here too, beside the reference's NaN
at the same inputs). Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

RTOL = 2e-5
SCAN_RTOL = 1e-3
B, L, H, P, N = 2, 16, 3, 8, 4


def _inputs(dt_scale: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    bm = rng.normal(size=(B, L, N)).astype(np.float32)
    cm = rng.normal(size=(B, L, N)).astype(np.float32)
    dt = (dt_scale * rng.uniform(0.5, 1.5, size=(B, L, H))).astype(
        np.float32)
    a = -np.exp(rng.normal(size=(H,))).astype(np.float32) - 1.0
    g_state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    g_y = rng.normal(size=(B, L, H, P)).astype(np.float32)
    return state, (x, bm, cm, dt), a, (g_state, g_y)


def _reference(state, chunk, a, cot):
    def f(state, x, bm, cm, dt, a):
        return j_ssm._ssd_chunk(state, (x, bm, cm, dt), A=a, nheads=H, p=P,
                                n=N)
    args = tuple(jnp.asarray(v) for v in (state, *chunk, a))
    out, vjp = jax.vjp(f, *args)
    return ([np.asarray(o) for o in out],
            [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot))])


def _port(state, chunk, a, cot):
    args = [torch.from_numpy(v).requires_grad_(True)
            for v in (state, *chunk, a)]
    out = t_ssm._ssd_chunk(args[0], tuple(args[1:5]), A=args[5])
    grads = torch.autograd.grad(out, args, [torch.from_numpy(c)
                                            for c in cot])
    return ([o.detach().numpy() for o in out], [g.numpy() for g in grads])


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        bar = RTOL * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= bar, (what, i, np.abs(g - w).max(), bar)


@pytest.mark.parametrize("seed", range(3))
def test_gradient_matches_reference_in_range(seed):
    state, chunk, a, cot = _inputs(0.05, seed)
    want_out, want_g = _reference(state, chunk, a, cot)
    got_out, got_g = _port(state, chunk, a, cot)
    assert all(np.isfinite(g).all() for g in want_g)
    _close(got_out, want_out, "forward")
    _close(got_g, want_g, "gradient")


def test_gradient_stays_finite_past_the_range():
    """dt |A| of ~10-40 a step: over 16 steps the exponent of the masked
    entries passes 88 (f32's exp overflows). The forward agrees with the
    reference's; the reference's gradient is NaN, the port's finite, and
    the port's equals its own with the masked entries never formed (one
    chunk a step: the state carries everything)."""
    state, chunk, a, cot = _inputs(6.0)
    want_out, want_g = _reference(state, chunk, a, cot)
    got_out, got_g = _port(state, chunk, a, cot)
    _close(got_out, want_out, "forward")
    assert not all(np.isfinite(g).all() for g in want_g)
    assert all(np.isfinite(g).all() for g in got_g)
    # the same gradient from single-step chunks, where no masked entry
    # exists: a sequential scan of the same recurrence. Its exponents are
    # differences of running sums of ~600, whose f32 spacing is 6e-5, so
    # the two orders agree to SCAN_RTOL, not to RTOL
    args = [torch.from_numpy(v).requires_grad_(True)
            for v in (state, *chunk, a)]
    st, ys = args[0], []
    for t in range(L):
        st, y = t_ssm._ssd_chunk(st, tuple(v[:, t:t + 1] for v in args[1:5]),
                                 A=args[5])
        ys.append(y)
    steps = torch.autograd.grad((st, torch.cat(ys, dim=1)), args,
                                [torch.from_numpy(c) for c in cot])
    for i, (g, w) in enumerate(zip(got_g, steps)):
        w = w.numpy()
        assert np.abs(g - w).max() <= SCAN_RTOL * max(np.abs(w).max(),
                                                       1e-30), i
