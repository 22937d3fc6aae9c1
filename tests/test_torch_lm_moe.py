"""The port's MoE layer and MoE LMs against the reference, on the CPU.

``models.moe.apply_moe`` against ``repro.models.moe.apply_moe`` on the same
weights and inputs (made from a seed with numpy): with a router that sends
most tokens to one expert, so tokens past its capacity are dropped (the
same tokens: the output differs from the no-drop one), at the reference
test's no-drop capacity factor, gated and ungated experts, a shared
expert; the aux loss; ``_capacity``. Then the olmoe and llama4 SMOKE
models (every layer MoE; MoE on every second layer with a shared expert)
end to end, as ``tests/_lm_parity.py`` states: forward and its summed aux
loss, prefill and decode steps against the reference's (from the port's
caches and from the reference's carried across), the port's decode
against its forward at the no-drop factor, and the params and caches
carried across. Outputs within 1e-5 of max |y| (f32, other summation
orders), the aux loss within 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import _lm_parity as P  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
Y_RTOL = 1e-5


def _params(cfg, rng, skew: float) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": rng.normal(size=(d, e)) / np.sqrt(d),
         "wi": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "wo": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    p["router"][:, 0] += skew / np.sqrt(d)     # most tokens pick expert 0
    if cfg.mlp_act in ("silu", "gelu"):
        p["wg"] = rng.normal(size=(e, d, f)) / np.sqrt(d)
    if cfg.moe.shared_expert:
        p["shared"] = {"wi": rng.normal(size=(d, f)) / np.sqrt(d),
                       "wg": rng.normal(size=(d, f)) / np.sqrt(d),
                       "wo": rng.normal(size=(f, d)) / np.sqrt(f)}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _moe_pair(cfg, p, x):
    want, jaux = j_moe.apply_moe(cfg[1], _tree(p, lambda a: jnp.asarray(
        a, jnp.float32)), jnp.asarray(x))
    got, aux = t_moe.apply_moe(cfg[0], _tree(p, lambda a: torch.from_numpy(
        a.astype(np.float32))), torch.from_numpy(x))
    return got.numpy(), float(aux), np.asarray(want), float(jaux)


def _act_cfgs(arch, act, factor):
    ours, theirs = P.configs(arch, factor)
    return (dataclasses.replace(ours, mlp_act=act),
            dataclasses.replace(theirs, mlp_act=act))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("skew", [0.0, 6.0])
def test_apply_moe_matches_reference(arch, act, skew):
    """The default capacity (1.25): with the skewed router expert 0 is
    asked for by more tokens than it holds, and the dropped tokens are the
    reference's; the no-drop factor gives another output there."""
    cfg = _act_cfgs(arch, act, 0.0)
    rng = np.random.default_rng(int(skew) + len(act))
    p = _params(cfg[0], rng, skew)
    x = rng.normal(size=(2, 40, cfg[0].d_model)).astype(np.float32)
    got, aux, want, jaux = _moe_pair(cfg, p, x)
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= Y_RTOL * np.abs(want).max()
    assert abs(aux - jaux) <= 1e-6 * max(abs(jaux), 1.0) and aux > 0
    nodrop = _act_cfgs(arch, act, P.NO_DROP)
    got_nd, _, want_nd, _ = _moe_pair(nodrop, p, x)
    assert np.abs(got_nd - want_nd).max() <= Y_RTOL * np.abs(want_nd).max()
    c = t_moe._capacity(40, cfg[0].moe.top_k, cfg[0].moe.num_experts,
                        cfg[0].moe.capacity_factor)
    if skew:                # > c tokens ask for expert 0: some are dropped
        assert np.abs(got_nd - got).max() > 1e-3 * np.abs(got_nd).max(), c


@pytest.mark.parametrize("s,k,e,factor", [
    (1, 1, 128, 1.25), (1, 8, 64, 1.25), (24, 2, 8, 1.25), (2048, 8, 64, 1.25),
    (2048, 1, 128, 1.25), (40, 2, 8, 100.0), (7, 3, 5, 0.5)])
def test_capacity_matches_reference(s, k, e, factor):
    assert t_moe._capacity(s, k, e, factor) == j_moe._capacity(s, k, e,
                                                               factor)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    P.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    P.check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """At the no-drop factor, as the reference test runs MoE archs: the
    tokens a 24-token forward drops differ from a 1-token decode's."""
    P.check_decode_matches_forward(arch, P.NO_DROP)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_carry_across(arch):
    P.check_params_and_caches(arch)
    _, _, lm = P.models(arch)
    moe_layers = [i for i, blk in enumerate(lm.layers) if blk.moe]
    interleave = lm.cfg.moe.interleave
    assert moe_layers == [i for i in range(lm.cfg.num_layers)
                          if i % interleave == interleave - 1]
    sd = lm.state_dict()
    if lm.cfg.moe.shared_expert:
        assert f"layers.{moe_layers[0]}.ffn.shared.wg" in sd
    assert f"layers.{moe_layers[0]}.ffn.router" in sd


@pytest.mark.parametrize("arch", ARCHS)
def test_pinned_routes_are_the_routers_own(arch):
    """``apply_moe(gate_idx=)`` at the router's own top-k is bit for bit the
    unpinned call; other choices give another output, with the gates
    renormalised over them."""
    cfg = P.configs(arch)[0]
    rng = np.random.default_rng(11)
    p = _tree(_params(cfg, rng, 3.0), lambda a: torch.from_numpy(
        a.astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(2, 30, cfg.d_model))
                         .astype(np.float32))
    probs, top = t_moe.route(cfg, p, x)
    assert top.shape == (2, 30, cfg.moe.top_k)
    assert float((probs.sum(-1) - 1.0).abs().max()) < 1e-5
    y, aux = t_moe.apply_moe(cfg, p, x)
    y2, aux2 = t_moe.apply_moe(cfg, p, x, gate_idx=top)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    other = (top + 1) % cfg.moe.num_experts
    y3, _ = t_moe.apply_moe(cfg, p, x, gate_idx=other)
    assert float((y3 - y).abs().max()) > 1e-3 * float(y.abs().max())


def test_rounding_probe_pins_choices_in_call_order():
    """``launch.lm_rounding.pinned_routes`` records each MoE layer's own
    choices and replays given ones in call order: the recorded choices
    give the unpinned logits bit for bit, others move them. Off the card
    the probe refuses to measure."""
    from repro_torch.launch import lm_rounding as lr
    _, _, lm = P.models("olmoe-1b-7b")
    e = lm.cfg.moe.num_experts
    b = P.as_torch(P.batch(lm.cfg, 2, 12, 9))
    own = []
    with torch.no_grad():
        base, _ = lm(b)
        with lr.pinned_routes(own):
            first, _ = lm(b)
        with lr.pinned_routes([], own):
            same, _ = lm(b)
        with lr.pinned_routes([], [(r + 1) % e for r in own]):
            moved, _ = lm(b)
    assert len(own) == lm.cfg.num_layers
    assert torch.equal(first, base) and torch.equal(same, base)
    assert float((moved - base).abs().max()) > 1e-3 * float(base.abs().max())
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="card"):
            lr.main(["--arch", "olmoe-1b-7b"])
