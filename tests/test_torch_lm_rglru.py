"""The port's RG-LRU block and the RecurrentGemma hybrid against the
reference, on the CPU.

``models.rglru`` against ``repro.models.rglru`` on the same weights and
inputs (made from a seed with numpy; the gates' and Lambda's f32 leaves
drawn too): ``_recurrence`` (the port's log-depth doubling scan against the
reference's ``lax.associative_scan``, with and without h0, at lengths 1
to 300, with and without a power of two), ``apply_rglru`` without a
cache, from a zero and a random cache, and the one-token decode. Then the
recurrentgemma SMOKE model (two RG-LRU layers and a local-attention layer
a period, plus a remainder layer) end to end (``tests/_lm_parity.py``).
The scan multiplies and adds in another order than XLA's: states within
``RTOL`` of their max.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import _lm_parity as P  # noqa: E402
from repro.models import rglru as j_rg  # noqa: E402
from repro_torch.models import rglru as t_rg  # noqa: E402

ARCH = "recurrentgemma-9b"
RTOL = 1e-5


def _close(got, want, what):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-30), \
        (what, np.abs(got - want).max())


@pytest.mark.parametrize("s", [1, 2, 5, 16, 24, 300])
@pytest.mark.parametrize("h0", [False, True])
def test_recurrence_matches_reference(s, h0):
    rng = np.random.default_rng(s + 1000 * h0)
    a = rng.uniform(0.0, 1.0, size=(2, s, 9)).astype(np.float32)
    b = rng.normal(size=(2, s, 9)).astype(np.float32)
    h = rng.normal(size=(2, 9)).astype(np.float32) if h0 else None
    got = t_rg._recurrence(torch.from_numpy(a), torch.from_numpy(b),
                           None if h is None else torch.from_numpy(h))
    want = j_rg._recurrence(jnp.asarray(a), jnp.asarray(b),
                            None if h is None else jnp.asarray(h))
    _close(got, want, "h")
    # the serial definition, in float64
    hs, prev = np.zeros((2, s, 9)), (np.zeros((2, 9)) if h is None else h)
    for t in range(s):
        prev = a[:, t] * prev + b[:, t]
        hs[:, t] = prev
    assert np.abs(got.double().numpy() - hs).max() <= RTOL * np.abs(hs).max()


def _params(cfg, rng) -> dict:
    d, w = cfg.d_model, cfg.rglru_width or cfg.d_model
    return {"in_x": rng.normal(size=(d, w)) / np.sqrt(d),
            "in_gate": rng.normal(size=(d, w)) / np.sqrt(d),
            "conv_w": rng.normal(size=(cfg.conv_width, w)) / 2,
            "out": rng.normal(size=(w, d)) / np.sqrt(w),
            "lambda_p": rng.normal(size=(w,)) - 1.0,
            "w_a": rng.normal(size=(w,)), "b_a": rng.normal(size=(w,)),
            "w_i": rng.normal(size=(w,)), "b_i": rng.normal(size=(w,))}


@pytest.mark.parametrize("s", [1, 7, 24])
@pytest.mark.parametrize("cache", ["none", "zero", "random"])
def test_apply_rglru_matches_reference(s, cache):
    """Without a cache (S = 1 then runs the scan), from prefill's zero cache
    and from a random state and conv window (S = 1: the decode update)."""
    cfg, jcfg = P.configs(ARCH)
    rng = np.random.default_rng(s + 7 * len(cache))
    p = _params(cfg, rng)
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    w = cfg.rglru_width
    u = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    h = np.zeros((2, w), np.float32)
    cv = np.zeros((2, cfg.conv_width - 1, w), np.float32)
    if cache == "random":
        h = rng.normal(size=h.shape).astype(np.float32)
        cv = rng.normal(size=cv.shape).astype(np.float32)
    tc = None if cache == "none" else t_rg.RGLRUCache(torch.from_numpy(h),
                                                       torch.from_numpy(cv))
    jc = None if cache == "none" else j_rg.RGLRUCache(jnp.asarray(h),
                                                       jnp.asarray(cv))
    got, gc = t_rg.apply_rglru(cfg, tp, torch.from_numpy(u), cache=tc)
    want, wc = j_rg.apply_rglru(jcfg, jp, jnp.asarray(u), cache=jc)
    _close(got, want, "y")
    assert (gc is None) == (wc is None)
    if gc is not None:
        _close(gc.h, wc.h, "state")
        _close(gc.conv, wc.conv, "conv window")
        assert gc.h.dtype == torch.float32


def test_forward_matches_reference():
    P.check_forward(ARCH)


def test_prefill_and_decode_match_reference():
    P.check_prefill_decode(ARCH)


def test_decode_matches_forward():
    P.check_decode_matches_forward(ARCH)


def test_params_and_caches_carry_across():
    P.check_params_and_caches(ARCH)
    _, _, lm = P.models(ARCH)
    kinds = [blk.kind for blk in lm.layers]
    assert kinds == [lm.cfg.pattern_for_layer(i)
                     for i in range(lm.cfg.num_layers)]
    sd = lm.state_dict()
    assert sd["layers.0.mix.lambda_p"].dtype == torch.float32
