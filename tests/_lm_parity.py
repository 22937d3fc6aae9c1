"""Shared checks of the port's LM families against the JAX reference, on the
CPU (imported by ``tests/test_torch_lm_*.py``; not a test module).

Each SMOKE model is built once per process: the reference ``LM`` with its
params from ``PRNGKey(0)`` and the port's ``LM`` with the same weights
carried by ``convert.lm_params_from_reference``. Inputs (tokens, patch and
audio embeddings) are made from a seed with numpy. SMOKE configs run in
f32; XLA and PyTorch sum in other orders, so logits are held within
``LOGIT_RTOL`` x max|logit| with equal greedy tokens, and the port's own
decode against its forward within ``DECODE_RTOL`` (the reference test's
bar, ``tests/test_models.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import LM

LOGIT_RTOL = 1e-4          # x max|logit|, f32 through a few layers
DECODE_RTOL = 2e-4         # the reference's decode-vs-forward bar
NO_DROP = 100.0            # the reference test's no-drop capacity factor

_MODELS: dict = {}


def configs(arch: str, capacity_factor: float = 0.0):
    """(port config, reference config) of ``arch``'s SMOKE model, with the
    MoE capacity factor replaced when one is given."""
    ours, theirs = get_config(arch, smoke=True), j_get_config(arch,
                                                              smoke=True)
    if capacity_factor:
        ours, theirs = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (ours, theirs))
    return ours, theirs


def models(arch: str, capacity_factor: float = 0.0):
    """(reference LM, its params, port LM with the same weights)."""
    key = (arch, capacity_factor)
    if key not in _MODELS:
        cfg, jcfg = configs(arch, capacity_factor)
        jlm = JLM(jcfg)
        params, _ = jlm.init(jax.random.PRNGKey(0))
        lm = LM(cfg, device="cpu")
        lm.load_state_dict(convert.lm_params_from_reference(
            numpy_tree(params), cfg))
        _MODELS[key] = (jlm, params, lm)
    return _MODELS[key]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch(cfg, b: int, s: int, seed: int) -> dict:
    """Tokens (B, S) and the frontend's embeddings, numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(b, s)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        out["audio_embeds"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def as_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def close(got, want, what: str, rtol: float = LOGIT_RTOL) -> None:
    err = rel_err(got, want)
    assert err <= rtol, (what, err)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1),
                                  err_msg=what)


def check_forward(arch: str, capacity_factor: float = 0.0) -> None:
    """forward's logits and aux loss against the reference's."""
    jlm, params, lm = models(arch, capacity_factor)
    b = batch(lm.cfg, 2, 24, 1)
    want, jaux = jax.jit(jlm.forward)(params, as_jax(b))
    with torch.no_grad():
        got, aux = lm(as_torch(b))
    assert got.shape == (2, 24, lm.cfg.padded_vocab)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    close(got, want, f"{arch} forward")
    assert abs(float(aux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)), 1.0)
    if lm.cfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0


def check_prefill_decode(arch: str, capacity_factor: float = 0.0) -> None:
    """Prefill of 18 tokens then 6 decode steps, from the port's own caches
    and from the reference's caches carried across, against the
    reference's; the carried caches equal the port's own."""
    jlm, params, lm = models(arch, capacity_factor)
    cfg = lm.cfg
    pre, steps = 18, 6
    b = batch(cfg, 2, pre + steps, 2)
    pb = dict(b, tokens=b["tokens"][:, :pre])
    jpre, jcaches = jax.jit(jlm.prefill, static_argnames=("max_len",))(
        params, as_jax(pb), max_len=pre + steps)
    with torch.no_grad():
        tpre, tcaches = lm.prefill(as_torch(pb), max_len=pre + steps)
    close(tpre, jpre, f"{arch} prefill")
    carried = convert.lm_caches_from_reference(numpy_tree(jcaches), cfg)
    same_caches(carried, tcaches, arch)
    dstep = jax.jit(jlm.decode_step)
    for t in range(pre, pre + steps):
        tok = b["tokens"][:, t:t + 1]
        want, jcaches = dstep(params, jcaches, jnp.asarray(tok),
                              jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            got, tcaches = lm.decode_step(tcaches, torch.from_numpy(tok), t)
            got2, carried = lm.decode_step(carried, torch.from_numpy(tok), t)
        close(got, want, f"{arch} decode {t}")
        close(got2, want, f"{arch} decode {t} from the reference's caches")
    same_caches(convert.lm_caches_from_reference(numpy_tree(jcaches), cfg),
                tcaches, f"{arch} after decode")


def same_caches(a, b, what: str, rtol: float = 1e-4) -> None:
    """Two cache lists: the same kinds and shapes, equal KV positions,
    tensors within ``rtol`` of the larger magnitude, and equal encoder
    outputs."""
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys(), (what, i)
        for key in x:
            for name, u, v in zip(x[key]._fields, x[key], y[key]):
                assert u.shape == v.shape and u.dtype == v.dtype, \
                    (what, i, key, name)
                if name == "positions":
                    assert torch.equal(u, v), (what, i)
                else:
                    scale = max(float(u.abs().max()), 1e-30)
                    assert float((u - v).abs().max()) <= rtol * scale, \
                        (what, i, key, name)
    ea, eb = a.encoder_out, b.encoder_out
    assert (ea is None) == (eb is None), what
    if ea is not None:
        assert float((ea - eb).abs().max()) <= 1e-4 * float(ea.abs().max())


def check_decode_matches_forward(arch: str,
                                 capacity_factor: float = 0.0) -> None:
    """The port's own prefill + token-by-token decode reproduces its full
    forward, at the reference test's bar."""
    _, _, lm = models(arch, capacity_factor)
    S, pre = 24, 18
    b = as_torch(batch(lm.cfg, 2, S, 1))
    with torch.no_grad():
        full, _ = lm(b)
        caches = lm.prefill(dict(b, tokens=b["tokens"][:, :pre]),
                            max_len=S)[1]
        errs = []
        for t in range(pre, S):
            dl, caches = lm.decode_step(caches, b["tokens"][:, t:t + 1], t)
            errs.append(float((dl[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / (float(full.abs().max()) + 1e-6) < DECODE_RTOL, errs


def check_params_and_caches(arch: str) -> None:
    """The reference's params carried to the port: exactly the port's
    state-dict keys, shapes and dtypes, each tensor bitwise its reference
    leaf; the reference's empty caches carried to the port: the port's
    ``init_caches`` kinds, shapes, dtypes and values."""
    jlm, params, lm = models(arch)
    cfg = lm.cfg
    sd = convert.lm_params_from_reference(numpy_tree(params), cfg)
    ours = lm.state_dict()
    assert sd.keys() == ours.keys()
    for name, t in sd.items():
        assert t.shape == ours[name].shape and t.dtype == ours[name].dtype, \
            name
        assert torch.equal(t, ours[name]), name
    theirs = convert.lm_caches_from_reference(
        numpy_tree(jlm.init_caches(3, 40)), cfg)
    same_caches(theirs, lm.init_caches(3, 40), f"{arch} init_caches",
                rtol=0.0)
