"""The gradient of the port's flash attention against the reference, on the
CPU.

``flash_attention_backward_plain`` (P from the row log-sum-exp, dV, dP,
dS = P o (dP - D), dK, dQ in f32; the plain version of
``csrc/fk_attention_bwd.cu``'s kernels) is held to autograd of
``flash_attention_plain`` and, through ``attend``'s kernel route
(``_attend_kernel``: q scaled by hd ** -0.5 before the kernel, the
transposed views, zero rows with no valid key), to ``jax.vjp`` of the
reference's ``_attend_local``. ``FlashAttentionFn`` carries the call on CPU
tensors too, where its launches run the plain versions. Cases: GQA groups
1, 2 and 7, a window, non-causal, ragged Sq / Skv, rows with no valid key
and holes in the key positions. Everything runs in f32 here, so the bar is
f32 rounding through a few sums: ``RTOL`` x max|grad| per tensor. Inputs
are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

RTOL = 2e-5        # x max|grad|, f32 sums in other orders

# name: (b, h, kv, sq, skv, hd, causal, window, query holes, key holes)
CASES = {
    "g1": (2, 3, 3, 17, 17, 16, True, 0, (), ()),
    "g2_ragged": (1, 4, 2, 13, 29, 8, True, 0, (), (3, 4)),
    "g7_window": (1, 7, 1, 40, 40, 8, True, 6, (), ()),
    "noncausal": (2, 4, 2, 11, 23, 16, False, 0, (), ()),
    "empty_rows": (1, 4, 2, 24, 24, 8, True, 0, (0, 9, 23), (5, 6, 7)),
    "window_empty": (1, 2, 1, 30, 30, 8, True, 4, (2,), (10, 11, 12, 13)),
}


def _inputs(case, seed=0):
    b, h, kv, sq, skv, hd, causal, window, qholes, kholes = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(size=(b, kv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv, skv, hd)).astype(np.float32)
    do = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    qpos = np.arange(skv - sq, skv, dtype=np.int32)
    kpos = np.arange(skv, dtype=np.int32)
    qpos[list(qholes)] = -7          # sees no key: an empty row
    kpos[list(kholes)] = -1          # empty key slots
    return q, k, v, do, qpos, kpos, causal, window


def _close(got, want, what):
    for name, g, w in zip("qkv", got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        bar = RTOL * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= bar, f"{what} d{name}: {err} > {bar}"


@pytest.mark.parametrize("zero_empty_rows", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_plain_matches_autograd(case, zero_empty_rows):
    q, k, v, do, qpos, kpos, causal, window = _inputs(case)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    out = fa.flash_attention_plain(qt, kt, vt, qp, kp, causal=causal,
                                   window=window,
                                   zero_empty_rows=zero_empty_rows)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    lse = fa.flash_lse_plain(qt.detach(), kt.detach(), qp, kp,
                             causal=causal, window=window)
    got = fa.flash_attention_backward_plain(
        qt.detach(), kt.detach(), vt.detach(), out.detach(),
        torch.from_numpy(do), lse, qp, kp, causal=causal, window=window,
        zero_empty_rows=zero_empty_rows)
    _close([g.numpy() for g in got], [w.numpy() for w in want], case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_is_the_masked_logsumexp(case):
    q, k, v, do, qpos, kpos, causal, window = _inputs(case)
    lse = fa.flash_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(qpos), torch.from_numpy(kpos),
                             causal=causal, window=window).numpy()
    g = q.shape[1] // k.shape[1]
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  np.repeat(k, g, axis=1).astype(np.float64))
    mask = (kpos[None, :] >= 0)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    mask = np.broadcast_to(mask, s.shape[2:])
    empty = ~mask.any(-1)
    s = np.where(mask, s, -np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
            + s.max(-1)
    assert np.all(np.isinf(lse[..., empty]) & (lse[..., empty] > 0))
    np.testing.assert_allclose(lse[..., ~empty], want[..., ~empty],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_route_grads_match_reference_vjp(case):
    """``attend``'s kernel route on CPU tensors (the hd ** -0.5 scaling
    before ``flash_attention``, which goes through ``FlashAttentionFn``)
    against ``jax.vjp`` of the reference's chunked attention: the scaling's
    backward scales dq back."""
    q, k, v, do, qpos, kpos, causal, window = _inputs(case)
    hd = q.shape[-1]
    # (B, S, H, hd) as attend takes them, unscaled
    qs, ks, vs, dos = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                       for a in (q * hd ** 0.5, k, v, do))

    def ref(q_, k_, v_):
        return j_attn._attend_local(
            q_, k_, v_, q_positions=jnp.asarray(qpos),
            kv_positions=jnp.asarray(kpos), causal=causal, window=window,
            chunk=8)
    out, vjp = jax.vjp(ref, jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs))
    want = vjp(jnp.asarray(dos))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (qs, ks, vs))
    counts = dict(fa.flash_attention.kernel_launches)
    got_out = t_attn._attend_kernel(qt, kt, vt,
                                    q_positions=torch.from_numpy(qpos),
                                    kv_positions=torch.from_numpy(kpos),
                                    causal=causal, window=window)
    # the result is the function's output, transposed back
    assert type(got_out.grad_fn.next_functions[0][0]).__name__ \
        == "FlashAttentionFnBackward"
    got = torch.autograd.grad(got_out, (qt, kt, vt), torch.from_numpy(dos))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    _close([g.numpy() for g in got], [np.asarray(w) for w in want], case)
    # on the CPU the function's launches are its plain versions
    assert fa.flash_attention.kernel_launches == counts
    assert fa.flash_bwd_prep.launches == fa.flash_bwd_dkdv.launches \
        == fa.flash_bwd_dq.launches == 0


def test_flash_attention_routes_through_the_function_with_grad():
    q, k, v, do, qpos, kpos, causal, window = _inputs("g2_ragged")
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, qp, kp, zero_empty_rows=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        plain = fa.flash_attention(qt, kt, vt, qp, kp, zero_empty_rows=True)
    assert plain.grad_fn is None and torch.equal(out.detach(), plain)
    frozen = fa.flash_attention(*(t.detach() for t in (qt, kt, vt)), qp, kp,
                                zero_empty_rows=True)
    assert frozen.grad_fn is None


def test_rounded_backward_stays_near_f32():
    """``round_to`` rounds P and dS where the kernels do: bf16's rounding
    floor, a few bf16 ulps of the largest gradient."""
    q, k, v, do, qpos, kpos, causal, window = _inputs("g7_window")
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    out = fa.flash_attention_plain(t[0], t[1], t[2], qp, kp, window=window,
                                   zero_empty_rows=True)
    lse = fa.flash_lse_plain(t[0], t[1], qp, kp, window=window)
    exact = fa.flash_attention_backward_plain(t[0], t[1], t[2], out, t[3],
                                              lse, qp, kp, window=window)
    rounded = fa.flash_attention_backward_plain(
        t[0], t[1], t[2], out, t[3], lse, qp, kp, window=window,
        round_to=torch.bfloat16)
    for a, b in zip(rounded, exact):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert 0 < err <= 2.0 ** -6 * scale


@pytest.mark.parametrize("what", ["f32", "hd256", "mean_rows"])
def test_unsupported_gradients_raise(what):
    """What the backward kernels do not take raises a named error before any
    launch (the card's route; the CPU's plain route takes everything): only
    ``zero_empty_rows=False`` (the mean-of-v rows no LM path asks for).
    f32 inputs (``csrc/fk_attention_bwd_f32.cu``) and hd 256
    (``csrc/fk_attention_bwd.cu``) pass."""
    dtype = torch.float32 if what == "f32" else torch.bfloat16
    hd = 256 if what == "hd256" else 128
    q = torch.zeros((1, 2, 4, hd), dtype=dtype)
    if what == "mean_rows":
        with pytest.raises(fa.FlashGradUnsupported):
            fa._check_grad(q, hd, False)
    else:
        fa._check_grad(q, hd, True)
    fa._check_grad(q.to(torch.float16), 64, True)
