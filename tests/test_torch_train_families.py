"""Two AdamW steps of every LM family's SMOKE config through the port's
``build_train_step`` against the reference's ``build_train_step`` on
``make_local_mesh()``, on the CPU, as ``tests/test_torch_train_step.py``
does for internlm2: the dense family with local windows (gemma3), the
RG-LRU hybrid (recurrentgemma), Mamba-2 SSD, MoE (olmoe), the
encoder-decoder (whisper) and the vision stub (qwen2-vl). Both packages
start from the reference's ``PRNGKey(0)`` weights and zero moments and
take the same numpy batches, which carry ``patch_embeds`` and
``audio_embeds`` as the reference's ``input_specs`` gives them (the port's
``data.synthetic.frontend_embeds`` names the same shapes); the port's
``TokenPipeline.for_config`` draws them.

Bars, f32 SMOKE models: the loss and ce within ``LOSS_RTOL``, lr to f32
rounding, the global norm within ``GNORM_RTOL``; every leaf's gradient
agrees to ``GRAD_RTOL`` = 1e-4 of its largest (``tests/_train_parity.py``:
these families sum in more orders than internlm2's 1e-5), so m is held
within ``M_RTOL`` and v within ``V_RTOL`` of each leaf's largest (measured
worst: 4.5e-5 and 6.8e-5, olmoe's wk); AdamW's first steps divide each
gradient by its own magnitude, so a parameter whose gradient is near zero
moves by a visible share of lr: within ``PARAM_ATOL`` = lr / 10 of the
reference's (measured worst: 7.6e-5 at lr 1e-3, olmoe's wq, whisper's
6.5e-5; the dense test's lr / 20 holds internlm2 at 1.5e-5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import _lm_parity as P  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import input_specs  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train.steps import build_train_step as j_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import (TokenPipeline,  # noqa: E402
                                        frontend_embeds)
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import build_train_step, init_opt_state  # noqa: E402
from repro_torch.train.optimizer import TrainConfig  # noqa: E402

LR = 1e-3
PARAM_ATOL = LR / 10
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
M_RTOL = 1e-4
V_RTOL = 2e-4
SEQ, BATCH = 16, 4
FAMILIES = {"dense": "gemma3-4b", "hybrid": "recurrentgemma-9b",
            "ssm": "mamba2-1.3b", "moe": "olmoe-1b-7b",
            "audio": "whisper-medium", "vlm": "qwen2-vl-7b"}


def _batches(cfg, n: int) -> list[dict]:
    """``n`` numpy batches: tokens and labels, and the frontend's
    embeddings at ``input_specs``' shapes, from a seed."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ + 1))
        b = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
        for name, (rows, width) in frontend_embeds(cfg).items():
            b[name] = rng.normal(size=(BATCH, rows, width)).astype(
                np.float32)
        out.append(b)
    return out


def _leafwise(got: dict, want: dict, what: str, atol=0.0, rtol=0.0):
    for name, g in got.items():
        w = want[name].double()
        bar = atol + rtol * max(float(w.abs().max()), 1e-30)
        err = float((g.detach().double() - w).abs().max())
        assert err <= bar, f"{what} {name}: {err} > {bar}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_steps_match_reference(family):
    arch = FAMILIES[family]
    cfg, jcfg = P.configs(arch)
    tcfg = TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10,
                       grad_accum=2)
    jshape = JShape("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    jb = j_build(jcfg, make_local_mesh(), jshape,
                 j_opt.TrainConfig(**dataclasses.asdict(tcfg)))
    params, _ = jb.lm.init(jax.random.PRNGKey(0))
    opt = j_opt.init_opt_state(params, j_opt.TrainConfig(
        **dataclasses.asdict(tcfg)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(convert.lm_params_from_reference(
        P.numpy_tree(params), cfg))
    step = build_train_step(cfg, ShapeConfig("t", seq_len=SEQ,
                                             global_batch=BATCH,
                                             kind="train"), tcfg,
                            device="cpu")
    ours = init_opt_state(dict(lm.named_parameters()), tcfg)
    batches = _batches(cfg, 2)
    specs = input_specs(jcfg, jshape)
    assert set(batches[0]) == set(specs)
    for name, spec in specs.items():
        assert batches[0][name].shape == spec.shape, name
    for i, batch in enumerate(batches):
        params, opt, jm = jb.step_fn(params, opt, P.as_jax(batch))
        m = step(lm, ours, {k: torch.from_numpy(v) for k, v in batch.items()})
        want_p = convert.lm_params_from_reference(P.numpy_tree(params), cfg)
        want_o = convert.opt_state_from_reference(P.numpy_tree(opt), cfg)
        assert int(ours["step"]) == int(want_o["step"]) == i + 1
        for key in ("loss", "ce"):
            assert float(m[key]) == pytest.approx(float(jm[key]),
                                                  rel=LOSS_RTOL)
        assert float(m["aux"]) == pytest.approx(float(jm["aux"]),
                                                rel=LOSS_RTOL, abs=1e-7)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=2e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GNORM_RTOL)
        _leafwise(dict(lm.named_parameters()), want_p, f"{arch} params {i}",
                  atol=PARAM_ATOL)
        _leafwise(ours["m"], want_o["m"], f"{arch} m {i}", rtol=M_RTOL)
        _leafwise(ours["v"], want_o["v"], f"{arch} v {i}", rtol=V_RTOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pipeline_draws_the_frontend_inputs(family):
    """``TokenPipeline.for_config``'s batches carry the frontend's
    embeddings at ``input_specs``' shapes in the model's dtype, drawn from
    (seed, step, shard); the tokens stay the pipeline's own draws."""
    arch = FAMILIES[family]
    cfg, jcfg = P.configs(arch)
    pipe = TokenPipeline.for_config(cfg, SEQ, BATCH, device="cpu")
    bare = TokenPipeline(cfg.vocab_size, SEQ, BATCH, device="cpu")
    a, b = pipe.next_batch(3), bare.next_batch(3)
    specs = input_specs(jcfg, JShape("t", seq_len=SEQ, global_batch=BATCH,
                                     kind="train"))
    assert set(a) == set(specs)
    for name, spec in specs.items():
        assert tuple(a[name].shape) == spec.shape, name
        if name.endswith("_embeds"):
            assert a[name].dtype == getattr(torch, cfg.dtype)
            assert torch.equal(a[name], pipe.next_batch(3)[name])
            assert not torch.equal(a[name], pipe.next_batch(4)[name])
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])


@pytest.mark.parametrize("shift", [1.37, 1.83])
def test_shifted_grid_route(shift):
    """``lm_rounding.attention_route("plain_grid:<shift>")``, one of phase
    20's rounding-sized changes of the plain route: the chunked math with P
    rounded to bf16 on a grid scaled by the shift. Its output and gradients
    sit within bf16's rounding of the plain route's and differ from them;
    the route restores ``attend``'s kernel route and block after."""
    from repro_torch.launch.lm_rounding import attention_route
    from repro_torch.models import attention as t_attn
    rng = np.random.default_rng(5)
    b, s, h, kv, hd = 2, 40, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
        for n in (h, kv, kv))
    do = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32)
    qpos = pos.clone()
    qpos[5] = -7                                   # a row with no key
    kw = dict(q_positions=qpos, kv_positions=pos, causal=True, window=9,
              chunk=16)
    before = (t_attn._attend_kernel, t_attn._block_attend)
    with attention_route(f"plain_grid:{shift}"):
        got = t_attn._attend_kernel(q, k, v, **kw)
    assert (t_attn._attend_kernel, t_attn._block_attend) == before
    want = t_attn._attend_local(q, k, v, **kw)
    scale = float(want.detach().float().abs().max())
    diff = float((got - want).detach().float().abs().max())
    assert 0 < diff <= 2.0 ** -6 * scale
    assert torch.all(got[:, 5] == 0)
    for g, w in zip(torch.autograd.grad(got, (q, k, v), do),
                    torch.autograd.grad(want, (q, k, v), do)):
        gap = float((g.float() - w.float()).abs().max())
        assert 0 < gap <= 2.0 ** -5 * float(w.float().abs().max())
