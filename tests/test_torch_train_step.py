"""``repro_torch.train.build_train_step`` against the reference's
``build_train_step`` on ``make_local_mesh()``, on the CPU: one and two AdamW
steps at one and two micro-batches, both packages starting from the
reference's ``PRNGKey(0)`` weights (``convert.lm_params_from_reference``)
and zero moments, on the same numpy batches. The new parameters, ``m``,
``v``, the step count, the loss, lr and grad norm are compared.

Bars: the SMOKE model runs in f32; the gradients agree to ~1e-5 of each
leaf's largest (``tests/_train_parity.py``), and AdamW's first steps divide
each gradient by its own magnitude, so a small gradient's rounding moves
its parameter by a visible share of ``lr``: parameters within
``PARAM_ATOL`` = lr / 20 (measured: 1.5e-5 at lr 1e-3), m within
``M_RTOL`` of the leaf's largest, v within ``V_RTOL`` (measured: under
5e-6), loss and lr to f32 rounding, the global norm within
``GNORM_RTOL``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _lm_parity as P  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train.steps import build_train_step as j_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import build_train_step, init_opt_state  # noqa: E402
from repro_torch.train.optimizer import TrainConfig  # noqa: E402
from repro_torch.train.steps import default_grad_accum  # noqa: E402

LR = 1e-3
PARAM_ATOL = LR / 20
M_RTOL = 2e-5
V_RTOL = 2e-5
GNORM_RTOL = 1e-5


def _batches(cfg, rows, seq, n):
    rng = np.random.default_rng(9)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, size=(rows, seq + 1))
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)})
    return out


def _leafwise(got: dict, want: dict, what: str, atol=0.0, rtol=0.0):
    for name, g in got.items():
        w = want[name].double()
        bar = atol + rtol * max(float(w.abs().max()), 1e-30)
        err = float((g.detach().double() - w).abs().max())
        assert err <= bar, f"{what} {name}: {err} > {bar}"


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    arch = "internlm2-1.8b"
    cfg, jcfg = P.configs(arch)
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    tcfg = TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10,
                       grad_accum=accum)
    jb = j_build(jcfg, make_local_mesh(),
                 JShape("t", seq_len=16, global_batch=4, kind="train"),
                 j_opt.TrainConfig(**dataclasses.asdict(tcfg)))
    params, _ = jb.lm.init(jax.random.PRNGKey(0))
    opt = j_opt.init_opt_state(params, j_opt.TrainConfig(
        **dataclasses.asdict(tcfg)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(convert.lm_params_from_reference(
        P.numpy_tree(params), cfg))
    step = build_train_step(cfg, shape, tcfg, device="cpu")
    ours = init_opt_state(dict(lm.named_parameters()), tcfg)
    for i, batch in enumerate(_batches(cfg, 4, 16, 2)):
        params, opt, jm = jb.step_fn(params, opt, P.as_jax(batch))
        m = step(lm, ours, {k: torch.from_numpy(v) for k, v in batch.items()})
        want_p = convert.lm_params_from_reference(P.numpy_tree(params), cfg)
        want_o = convert.opt_state_from_reference(P.numpy_tree(opt), cfg)
        assert int(ours["step"]) == int(want_o["step"]) == i + 1
        for key in ("loss", "ce", "lr"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=2e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GNORM_RTOL)
        _leafwise(dict(lm.named_parameters()), want_p, f"params {i}",
                  atol=PARAM_ATOL)
        _leafwise(ours["m"], want_o["m"], f"m {i}", rtol=M_RTOL)
        _leafwise(ours["v"], want_o["v"], f"v {i}", rtol=V_RTOL)


def test_accumulation_buffer_is_f32_for_bf16_params():
    """bf16 parameters: the micro-batches' gradients are summed in the f32
    buffer (``accum_dtype``), not in bf16 ``.grad``: two micro-batches of
    one batch equal the batch taken whole, within f32 rounding of the
    bf16 gradients' sum."""
    cfg = dataclasses.replace(P.configs("internlm2-1.8b")[0],
                              dtype="bfloat16", param_dtype="bfloat16")
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg, 4, 16, 1)[0].items()}
    got = {}
    for accum in (1, 2):
        lm = LM(cfg, device="cpu", seed=3)
        tcfg = TrainConfig(learning_rate=LR, warmup_steps=0, total_steps=4,
                           grad_accum=accum, grad_clip=0.0)
        opt = init_opt_state(dict(lm.named_parameters()), tcfg)
        got[accum] = build_train_step(cfg, shape, tcfg, device="cpu")(
            lm, opt, batch)
    assert float(got[2]["loss"]) == pytest.approx(float(got[1]["loss"]),
                                                  rel=2e-2)
    assert float(got[2]["grad_norm"]) == pytest.approx(
        float(got[1]["grad_norm"]), rel=2e-2)


def test_default_grad_accum_is_the_reference_rule():
    from repro.train.steps import default_grad_accum as j_default
    for gb in (1, 8, 63, 64, 256):
        shape = ShapeConfig("t", 16, gb, "train")
        assert default_grad_accum(shape) == j_default(
            JShape("t", 16, gb, "train"))
