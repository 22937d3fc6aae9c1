"""The port's Mamba-2 SSD block and the mamba2 LM against the reference, on
the CPU.

``models.ssm`` against ``repro.models.ssm`` on the same weights and inputs
(made from a seed with numpy; ``A_log``, ``D``, ``dt_bias`` and the norm
drawn too, so every term counts): ``dims``, ``_causal_conv`` with and
without a carry, ``apply_ssm`` over several chunks (``chunk=8`` at S = 24,
so the state crosses chunk boundaries, and at S = 21, padded), from a zero
and from a random cache, and the one-token decode update. Then the mamba2
SMOKE model end to end (``tests/_lm_parity.py``). The chunk loop and the
products sum in another order than XLA's: outputs and states within
``RTOL`` of their max.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import _lm_parity as P  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

ARCH = "mamba2-1.3b"
RTOL = 2e-5


def _close(got, want, what):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-30), \
        (what, np.abs(got - want).max())


def _params(cfg, rng) -> dict:
    d = cfg.d_model
    inner, h, p, n = t_ssm.dims(cfg)
    return {"in_proj": rng.normal(size=(d, 2 * inner + 2 * n + h))
            / np.sqrt(d),
            "conv_w": rng.normal(size=(cfg.conv_width, inner + 2 * n)) / 2,
            "out_proj": rng.normal(size=(inner, d)) / np.sqrt(inner),
            "A_log": rng.normal(size=(h,)) / 2,
            "D": 1.0 + rng.normal(size=(h,)) / 4,
            "dt_bias": rng.normal(size=(h,)) / 2,
            "norm": {"scale": 1.0 + rng.normal(size=(inner,)) / 4}}


def _both(p):
    def conv(fn):
        return {k: conv_one(v, fn) for k, v in p.items()}

    def conv_one(v, fn):
        return {k: fn(a) for k, a in v.items()} if isinstance(v, dict) \
            else fn(v)
    return (conv(lambda a: torch.from_numpy(a.astype(np.float32))),
            conv(lambda a: jnp.asarray(a, jnp.float32)))


def _cfg(heads=0):
    ours, theirs = P.configs(ARCH)
    if heads:
        ours, theirs = (dataclasses.replace(c, ssm_heads=heads)
                        for c in (ours, theirs))
    return ours, theirs


@pytest.mark.parametrize("heads", [0, 2, 4])
def test_dims_match_reference(heads):
    ours, theirs = _cfg(heads)
    assert t_ssm.dims(ours) == j_ssm.dims(theirs)
    full = P.configs(ARCH)[0]
    assert t_ssm.dims(dataclasses.replace(
        full, d_model=2048, ssm_heads=64, ssm_state=128)) == (4096, 64, 64,
                                                              128)


@pytest.mark.parametrize("s", [1, 3, 24])
@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_reference(s, carry):
    rng = np.random.default_rng(s + 10 * carry)
    u = rng.normal(size=(2, s, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    c = rng.normal(size=(2, 3, 12)).astype(np.float32) if carry else None
    got, gc = t_ssm._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                                 None if c is None else torch.from_numpy(c))
    want, wc = j_ssm._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                  None if c is None else jnp.asarray(c))
    _close(got, want, "conv")
    _close(gc, wc, "carry")


@pytest.mark.parametrize("s,chunk", [(24, 8), (21, 8), (24, 256), (40, 16)])
@pytest.mark.parametrize("cache", ["none", "zero", "random"])
def test_apply_ssm_chunked_matches_reference(s, chunk, cache):
    """Prefill through several chunks: the state carried across chunk
    boundaries (and padded at S = 21), without a cache, from the zero cache
    prefill makes, and from a random state and conv window."""
    cfg = _cfg()
    rng = np.random.default_rng(s + chunk)
    tp, jp = _both(_params(cfg[0], rng))
    u = rng.normal(size=(2, s, cfg[0].d_model)).astype(np.float32)
    inner, h, p, n = t_ssm.dims(cfg[0])
    st = np.zeros((2, h, p, n), np.float32)
    cv = np.zeros((2, cfg[0].conv_width - 1, inner + 2 * n), np.float32)
    if cache == "random":
        st = rng.normal(size=st.shape).astype(np.float32)
        cv = rng.normal(size=cv.shape).astype(np.float32)
    tc = None if cache == "none" else t_ssm.SSMCache(torch.from_numpy(st),
                                                      torch.from_numpy(cv))
    jc = None if cache == "none" else j_ssm.SSMCache(jnp.asarray(st),
                                                      jnp.asarray(cv))
    got, gcache = t_ssm.apply_ssm(cfg[0], tp, torch.from_numpy(u), cache=tc,
                                  chunk=chunk)
    want, wcache = j_ssm.apply_ssm(cfg[1], jp, jnp.asarray(u), cache=jc,
                                   chunk=chunk)
    _close(got, want, "y")
    assert (gcache is None) == (wcache is None)
    if gcache is not None:
        _close(gcache.state, wcache.state, "state")
        _close(gcache.conv, wcache.conv, "conv window")
        assert gcache.state.dtype == torch.float32


def test_chunks_agree_with_one_chunk():
    """The port's own chunk loop: chunk 8 (three chunks, state handed on)
    and one 256-row chunk give the same output and exit state."""
    cfg = _cfg()[0]
    rng = np.random.default_rng(7)
    tp, _ = _both(_params(cfg, rng))
    u = torch.from_numpy(rng.normal(size=(2, 24, cfg.d_model))
                         .astype(np.float32))
    c = t_ssm.init_cache(cfg, 2, torch.float32)
    a, ca = t_ssm.apply_ssm(cfg, tp, u, cache=c, chunk=8)
    b, cb = t_ssm.apply_ssm(cfg, tp, u, cache=c, chunk=256)
    assert float((a - b).abs().max()) <= RTOL * float(b.abs().max())
    assert float((ca.state - cb.state).abs().max()) <= RTOL * float(
        cb.state.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_ssm_decode_matches_reference(seed):
    """The one-token update of a random state and conv window."""
    cfg = _cfg()
    rng = np.random.default_rng(100 + seed)
    tp, jp = _both(_params(cfg[0], rng))
    inner, h, p, n = t_ssm.dims(cfg[0])
    u = rng.normal(size=(3, 1, cfg[0].d_model)).astype(np.float32)
    st = rng.normal(size=(3, h, p, n)).astype(np.float32)
    cv = rng.normal(size=(3, cfg[0].conv_width - 1, inner + 2 * n)
                    ).astype(np.float32)
    got, gc = t_ssm.apply_ssm(cfg[0], tp, torch.from_numpy(u),
                              cache=t_ssm.SSMCache(torch.from_numpy(st),
                                                   torch.from_numpy(cv)))
    want, wc = j_ssm.apply_ssm(cfg[1], jp, jnp.asarray(u),
                               cache=j_ssm.SSMCache(jnp.asarray(st),
                                                    jnp.asarray(cv)))
    _close(got, want, "y")
    _close(gc.state, wc.state, "state")
    _close(gc.conv, wc.conv, "conv window")


def test_init_ssm_f32_leaves():
    cfg = P.configs(ARCH)[0]
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    p = t_ssm.init_ssm(torch.Generator().manual_seed(0), bf, torch.bfloat16)
    assert p["in_proj"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    assert p["norm"]["scale"].dtype == torch.bfloat16


def test_forward_matches_reference():
    P.check_forward(ARCH)


def test_prefill_and_decode_match_reference():
    P.check_prefill_decode(ARCH)


def test_decode_matches_forward():
    P.check_decode_matches_forward(ARCH)


def test_params_and_caches_carry_across():
    P.check_params_and_caches(ARCH)
    _, _, lm = P.models(ARCH)
    assert all(not hasattr(blk, "ffn") for blk in lm.layers)   # no FFN
