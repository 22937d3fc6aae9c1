"""The port's training pieces against the reference, on the CPU: the
synthetic token pipeline (equal value for value), ``lr_at`` for the three
schedules, ``adamw_update`` (f32 and bf16 parameters and moments, the
global-norm clip on and off) and ``ft_einsum``'s gradient with ABFT on
(the reference's ``custom_vjp``: the plain einsums' gradient, also when a
fault in the product is corrected). Inputs are made from a seed with numpy.

Bars: ``lr_at`` within ``LR_RTOL`` (the cosine's f32 ``cos`` of two
libraries); AdamW's f32 results within ``ADAM_RTOL`` (the global norm sums
the leaves in another order, the update divides by sqrt(v)), bf16 results
within one bf16 ulp of the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import TokenPipeline as JPipeline  # noqa: E402
from repro.ft import abft_dense as j_abft  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.ft import abft_dense as t_abft  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402

LR_RTOL = 2.0 ** -21
ADAM_RTOL = 2e-6


# --- (a) the token pipeline ---------------------------------------------------

@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 4)])
def test_token_pipeline_equals_reference(seed, shard, num_shards):
    ours = TokenPipeline(1000, 33, 8, seed=seed, shard=shard,
                         num_shards=num_shards, device="cpu")
    theirs = JPipeline(1000, 33, 8, seed=seed, shard=shard,
                       num_shards=num_shards)
    for step in (0, 1, 6, 7, 123):
        got, want = ours.next_batch(step), theirs.next_batch(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int64
            assert got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_token_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        TokenPipeline(100, 8, 2)


# --- (b) lr_at, adamw_update --------------------------------------------------

def _tcfg(schedule, **kw):
    return dataclasses.replace(
        t_opt.TrainConfig(learning_rate=3e-3, warmup_steps=7,
                          total_steps=50, schedule=schedule), **kw)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches_reference(schedule):
    ours = _tcfg(schedule)
    theirs = j_opt.TrainConfig(**dataclasses.asdict(ours))
    for step in range(0, 56):
        got = float(t_opt.lr_at(ours, torch.tensor(step, dtype=torch.int32)))
        want = float(j_opt.lr_at(theirs, step))
        assert got == pytest.approx(want, rel=LR_RTOL, abs=1e-12), step


def _tree(seed, dtypes):
    rng = np.random.default_rng(seed)
    shapes = {"a.w": (5, 7), "b.scale": (7,), "c.w": (3, 4, 2)}
    return {name: (rng.normal(size=shape) * 2).astype(np.float32)
            for name, shape in shapes.items()}, dtypes


def _j(a, dt):
    return jnp.asarray(a).astype(dt)


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(param_dtype, state_dtype, clip):
    """Two steps from zero moments: new parameters, m, v, the step count,
    lr and the global norm (clip 1 scales these gradients down; clip 0
    leaves them)."""
    params, _ = _tree(0, None)
    cfg = _tcfg("cosine", grad_clip=clip, opt_state_dtype=state_dtype,
                warmup_steps=1)
    jcfg = j_opt.TrainConfig(**dataclasses.asdict(cfg))
    # copies: the update runs in place, and jnp.asarray may share the
    # numpy buffers
    pt = {n: torch.tensor(a, dtype=getattr(torch, param_dtype))
          for n, a in params.items()}
    pj = {n: _j(a, param_dtype) for n, a in params.items()}
    ot = t_opt.init_opt_state(pt, cfg)
    oj = j_opt.init_opt_state(pj, jcfg)
    for step in range(2):
        grads, _ = _tree(10 + step, None)
        gt = {n: torch.from_numpy(a).to(getattr(torch, param_dtype))
              for n, a in grads.items()}
        gj = {n: _j(a, param_dtype) for n, a in grads.items()}
        mt = t_opt.adamw_update(pt, gt, ot, cfg)
        pj, oj, mj = j_opt.adamw_update(pj, gj, oj, jcfg)
        assert int(ot["step"]) == int(oj["step"]) == step + 1
        for key in ("lr", "grad_norm"):
            assert float(mt[key]) == pytest.approx(float(mj[key]),
                                                   rel=ADAM_RTOL)
        for got, want, dt in ((pt, pj, param_dtype),
                              (ot["m"], oj["m"], state_dtype),
                              (ot["v"], oj["v"], state_dtype)):
            for n in got:
                g = got[n].float().numpy()
                w = np.asarray(want[n].astype(jnp.float32))
                assert str(got[n].dtype) == f"torch.{dt}"
                ulp = 2.0 ** -8 if dt == "bfloat16" else ADAM_RTOL
                np.testing.assert_allclose(g, w, rtol=ulp, atol=1e-12,
                                           err_msg=f"{n} step {step}")


def test_global_norm_is_the_reference_norm():
    tree, _ = _tree(3, None)
    got = float(t_opt.global_norm(torch.from_numpy(a) for a in tree.values()))
    want = float(j_opt.global_norm({n: jnp.asarray(a)
                                    for n, a in tree.items()}))
    assert got == pytest.approx(want, rel=ADAM_RTOL)


# --- (d) ft_einsum's gradient ---------------------------------------------------

SPECS = [("bsd,df->bsf", (2, 8, 16), (16, 32)),
         ("bsd,dhk->bshk", (2, 8, 16), (16, 4, 8)),
         ("bshk,hkd->bsd", (2, 8, 4, 8), (4, 8, 16))]


def _ft_grads(spec, x, w, g, enabled):
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = t_abft.ft_einsum(spec, xt, wt, enabled=enabled)
    return (out.detach(),) + torch.autograd.grad(out, (xt, wt),
                                                 torch.from_numpy(g))


@pytest.mark.parametrize("spec,xs,ws", SPECS)
def test_ft_einsum_gradient_is_the_plain_einsums(spec, xs, ws):
    rng = np.random.default_rng(4)
    x = rng.normal(size=xs).astype(np.float32)
    w = rng.normal(size=ws).astype(np.float32)
    out_shape = np.einsum(spec, x, w).shape
    g = rng.normal(size=out_shape).astype(np.float32)
    plain = _ft_grads(spec, x, w, g, enabled=False)
    prot = _ft_grads(spec, x, w, g, enabled=True)
    for a, b in zip(prot[1:], plain[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    _, vjp = jax.vjp(lambda a, b: j_abft.ft_einsum(spec, a, b, enabled=True),
                     jnp.asarray(x), jnp.asarray(w))
    for a, b in zip(prot[1:], vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_ft_einsum_corrects_a_fault_and_keeps_the_gradient(monkeypatch):
    """A fault planted in the product before the check: the output comes
    back corrected, and the gradient is the clean one (the backward never
    reads the product)."""
    spec, xs, ws = SPECS[0]
    rng = np.random.default_rng(5)
    x = rng.normal(size=xs).astype(np.float32)
    w = rng.normal(size=ws).astype(np.float32)
    g = rng.normal(size=(2, 8, 32)).astype(np.float32)
    clean = _ft_grads(spec, x, w, g, enabled=True)
    check = t_abft.detect_correct

    def faulty(spec_, x_, w_, d):
        d = d.clone()
        d[1, 5, 17] += 1000.0
        return check(spec_, x_, w_, d)
    monkeypatch.setattr(t_abft, "detect_correct", faulty)
    hit = _ft_grads(spec, x, w, g, enabled=True)
    np.testing.assert_allclose(hit[0].numpy(), clean[0].numpy(), rtol=1e-4,
                               atol=1e-3)
    assert torch.equal(hit[1], clean[1]) and torch.equal(hit[2], clean[2])
