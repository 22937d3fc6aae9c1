"""mamba2's bf16 decode against its own forward, in both packages, on the
CPU.

At full width on the card the port's bf16 mamba2 decode moves away from its
full forward step by step (``chip_smoke.py`` phase 16 records the drift,
ungated). Whether that is the SSD arithmetic in bf16 or a fault of the port
is read here: the SMOKE model in bf16 (weights from the reference's
``PRNGKey(0)``, carried by ``convert``) runs a prefill of ``PROMPT`` tokens
and ``STEPS`` decode steps in each package, each against its own forward
over the same tokens. Each step's drift is max|decode - forward| over
max|forward| of that step's logits. The port's drift must stay within
``FACTOR`` x the reference's worst step (and its f32 decode within the
reference test's bar, ``tests/_lm_parity.py``'s ``DECODE_RTOL``); the
control: a decode from caches that forgot the prompt breaks that bar.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _lm_parity as P  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import LM  # noqa: E402

ARCH = "mamba2-1.3b"
PROMPT, STEPS = 9, 15
# the port's worst step over the reference's: the two packages round bf16
# at other places, so their drifts differ by rounding, not by kind
FACTOR = 2.0


def _models(dtype: str):
    cfg, jcfg = P.configs(ARCH)
    cfg, jcfg = (dataclasses.replace(c, dtype=dtype, param_dtype=dtype)
                 for c in (cfg, jcfg))
    jlm = JLM(jcfg)
    params, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(convert.lm_params_from_reference(
        P.numpy_tree(params), cfg))
    return jlm, params, lm


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _drifts(dtype: str, forget: bool = False):
    """(the reference's, the port's) drift of each decode step from its own
    forward; ``forget``: the port decodes from caches that forgot the
    prompt (zeroed states)."""
    jlm, params, lm = _models(dtype)
    b = P.batch(lm.cfg, 2, PROMPT + STEPS, 3)
    toks = b["tokens"]
    jfull, _ = jax.jit(jlm.forward)(params, P.as_jax(b))
    jpre, jc = jax.jit(jlm.prefill, static_argnames=("max_len",))(
        params, P.as_jax(dict(b, tokens=toks[:, :PROMPT])),
        max_len=PROMPT + STEPS)
    dstep = jax.jit(jlm.decode_step)
    ref = []
    for t in range(PROMPT, PROMPT + STEPS):
        lg, jc = dstep(params, jc, jnp.asarray(toks[:, t:t + 1]),
                       jnp.asarray(t, jnp.int32))
        ref.append(_rel(np.asarray(lg, np.float32)[:, 0],
                        np.asarray(jfull, np.float32)[:, t]))
    ours = []
    with torch.no_grad():
        tb = P.as_torch(b)
        full, _ = lm(tb)
        _, caches = lm.prefill(dict(tb, tokens=tb["tokens"][:, :PROMPT]),
                               max_len=PROMPT + STEPS)
        if forget:
            caches = lm.init_caches(2, PROMPT + STEPS)
        for t in range(PROMPT, PROMPT + STEPS):
            lg, caches = lm.decode_step(caches, tb["tokens"][:, t:t + 1], t)
            ours.append(_rel(lg[:, 0].float().numpy(),
                             full[:, t].float().numpy()))
    return ref, ours


def test_bf16_decode_drift_is_the_references():
    ref, ours = _drifts("bfloat16")
    assert max(ref) > 0 and all(np.isfinite(ours))
    assert max(ours) <= FACTOR * max(ref), (ours, ref)


def test_f32_decode_stays_on_its_forward():
    ref, ours = _drifts("float32")
    assert max(ref) < P.DECODE_RTOL and max(ours) < P.DECODE_RTOL, \
        (ours, ref)


def test_control_forgotten_prompt_breaks_the_bar():
    ref, _ = _drifts("bfloat16")
    _, ours = _drifts("bfloat16", forget=True)
    assert ours[0] > FACTOR * max(ref), (ours[0], ref)
