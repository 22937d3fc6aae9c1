"""The port's LM serving stack against the reference, on the CPU.

Configs, ``ft_einsum``, the layers, and the dense SMOKE models (internlm2,
gemma3's ring buffer, minicpm's head dim 64 and padded vocab, nemotron's
squared ReLU and untied embeddings: forward, prefill logits and caches,
decode steps) with weights
carried across by ``convert.lm_params_from_reference``; the micro-batcher
and the launcher, for every arch. The other families have files of their own
(``tests/test_torch_lm_{moe,ssm,rglru,encdec}.py``). SMOKE configs run in
f32; XLA and PyTorch sum in other
orders, so logits are held within ``LOGIT_RTOL`` x max|logit| and greedy
tokens must be equal. Inputs are made from a seed with numpy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.ft import abft_dense as j_abft  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.ft import abft_dense as t_abft  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.serve import MicroBatcher  # noqa: E402

LOGIT_RTOL = 1e-4          # x max|logit|, f32 through a few layers
DECODE_RTOL = 2e-4         # the reference's decode-vs-forward bar
# gemma3: ATTN_LOCAL + ring buffer; minicpm: hd 64, vocab 509 padded to
# 512; nemotron: relu2, untied embeddings
ARCHS = ("internlm2-1.8b", "gemma3-4b", "minicpm-2b", "nemotron-4-15b")


# --- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    ours, theirs = get_config(arch, smoke=smoke), j_get_config(arch,
                                                               smoke=smoke)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()
    assert ours.padded_vocab == theirs.padded_vocab
    assert ours.resolved_head_dim == theirs.resolved_head_dim


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_and_serves(arch):
    """Every SMOKE config builds on the CPU (``check_supported`` refuses
    none) and serves a prefill and two decode steps with finite logits;
    ``init_caches`` gives each layer the cache kind of its block."""
    cfg = get_config(arch, smoke=True)
    check_supported(cfg)
    lm = LM(cfg, device="cpu")
    batch = t_serve.frontend_inputs(cfg, 2, "cpu")
    batch["tokens"] = torch.from_numpy(_tokens(cfg, 2, 20, 7))
    with torch.no_grad():
        logits, caches = lm.prefill(batch, max_len=22)
        for t in (20, 21):
            step, caches = lm.decode_step(caches, batch["tokens"][:, -1:], t)
            assert step.shape == (2, 1, cfg.padded_vocab)
            assert bool(torch.isfinite(step).all())
    assert logits.shape == (2, 20, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    kinds = {"attn": "kv", "attn_local": "kv", "rglru": "rglru", "ssd": "ssm"}
    empty = lm.init_caches(2, 22)
    for i, (c, e) in enumerate(zip(caches, empty)):
        assert c.keys() == e.keys() == {kinds[cfg.pattern_for_layer(i)]}
    assert (caches.encoder_out is None) == (not cfg.encoder_decoder)


def test_check_supported_refuses_unknown_blocks():
    cfg = get_config("internlm2-1.8b", smoke=True)
    with pytest.raises(ValueError, match="block kind"):
        check_supported(dataclasses.replace(cfg, layer_pattern=("mlp",)))
    with pytest.raises(ValueError, match="frontend"):
        check_supported(dataclasses.replace(cfg, frontend="video"))


def test_lm_defaults_to_cuda():
    cfg = get_config("internlm2-1.8b", smoke=True)
    if torch.cuda.is_available():
        assert LM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            LM(cfg)


# --- ft_einsum ----------------------------------------------------------------

SPECS = [("bsd,dhk->bshk", (2, 5, 8), (8, 4, 3)),
         ("bshk,hkd->bsd", (2, 5, 4, 3), (4, 3, 8)),
         ("bsd,df->bsf", (3, 4, 8), (8, 16))]


@pytest.mark.parametrize("spec,xs,ws", SPECS)
@pytest.mark.parametrize("enabled", [False, True])
def test_ft_einsum_matches_reference(spec, xs, ws, enabled):
    rng = np.random.default_rng(0)
    x = rng.normal(size=xs).astype(np.float32)
    w = rng.normal(size=ws).astype(np.float32)
    want = j_abft.ft_einsum(spec, jnp.asarray(x), jnp.asarray(w),
                            enabled=enabled)
    got = t_abft.ft_einsum(spec, torch.from_numpy(x), torch.from_numpy(w),
                           enabled=enabled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert t_abft._parse(spec, x, w) == j_abft._parse(spec, x, w)


@pytest.mark.parametrize("spec,xs,ws", SPECS)
def test_detect_correct_locates_and_fixes_one_upset(spec, xs, ws):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=xs).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=ws).astype(np.float32))
    clean = torch.einsum(spec, x, w)
    assert torch.equal(t_abft.detect_correct(spec, x, w, clean), clean)
    bad = clean.clone()
    flat = bad.view(-1)
    where = flat.numel() // 2 + 3
    flat[where] += 1e3                         # an exponent-sized upset
    fixed = t_abft.detect_correct(spec, x, w, bad)
    err = (fixed - clean).abs()
    assert float(err.view(-1)[where]) < 1e-2
    assert float(err.max()) < 1e-2


def test_ft_context_switch():
    assert not t_abft.ft_enabled()
    t_abft.configure(True)
    try:
        assert t_abft.ft_enabled()
    finally:
        t_abft.configure(False)
    with pytest.raises(ValueError):
        t_abft.detect_correct("ij,jk", torch.zeros(2, 2), torch.zeros(2, 2),
                              torch.zeros(2, 2))


# --- layers -------------------------------------------------------------------

def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32) + 3, (2, 6))
    got = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                              10_000.0)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pos3 = np.stack([pos, pos // 2, pos % 3], axis=-1)      # M-RoPE streams
    got = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3),
                              1e6, (2, 3, 3))
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                               (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    h = rng.normal(size=(2, 6, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        t_layers.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(h)).numpy(),
        np.asarray(j_layers.rmsnorm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(h))), rtol=1e-5, atol=1e-6)
    for act in ("silu", "gelu", "relu2"):
        w = {n: rng.normal(size=s).astype(np.float32) / 6 for n, s in
             (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
        if not t_layers.mlp_gated(act):
            del w["wg"]
        got = t_layers.apply_mlp({n: torch.from_numpy(a) for n, a in
                                  w.items()}, torch.from_numpy(h), act)
        want = j_layers.apply_mlp({n: jnp.asarray(a) for n, a in w.items()},
                                  jnp.asarray(h), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=act)


@pytest.mark.parametrize("s", [2048 ** 0.5, 128 ** -0.5, 16 ** -0.5])
def test_bf16_scalar_rounds_like_the_reference(s):
    """``x * jnp.asarray(s, bf16)`` (the embedding scale) and
    ``q * hd ** -0.5`` (a weak-typed scalar) both round s to bf16 first;
    ``layers.scaled`` matches them bit for bit, where a bf16 tensor times
    the Python float would not always."""
    x = np.random.default_rng(3).normal(size=(4096,)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_arr = np.asarray((xb * jnp.asarray(s, jnp.bfloat16))
                          .astype(jnp.float32))
    want_weak = np.asarray((xb * s).astype(jnp.float32))
    got = t_layers.scaled(torch.from_numpy(x).bfloat16(), s).float().numpy()
    np.testing.assert_array_equal(got, want_arr)
    np.testing.assert_array_equal(got, want_weak)


def test_logits_are_f32_of_bf16_operands():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    e = rng.normal(size=(96, 64)).astype(np.float32)
    xb, eb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16)
    want = j_layers.logits({"embedding": eb}, xb, tie=True)
    got = t_layers.logits({"embedding": torch.from_numpy(e).bfloat16()},
                          torch.from_numpy(x).bfloat16(), tie=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --- the SMOKE models against the reference ----------------------------------

_MODELS: dict = {}


def _models(arch):
    """(jax LM, its params, port LM with the same weights), built once."""
    if arch not in _MODELS:
        cfg = get_config(arch, smoke=True)
        jlm = JLM(j_get_config(arch, smoke=True))
        params, _ = jlm.init(jax.random.PRNGKey(0))
        lm = LM(cfg, device="cpu")
        lm.load_state_dict(convert.lm_params_from_reference(
            jax.tree_util.tree_map(np.asarray, params), cfg))
        _MODELS[arch] = (jlm, params, lm)
    return _MODELS[arch]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _close(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), (what, err)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jlm, params, lm = _models(arch)
    toks = _tokens(lm.cfg, 2, 40, 1)
    want, _ = jax.jit(jlm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = lm({"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 40, lm.cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want, "forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill longer than gemma3's 16-token window (the ring branch),
    then 6 decode steps from each package's own caches and from the
    reference's caches carried across."""
    jlm, params, lm = _models(arch)
    cfg = lm.cfg
    pre, steps = 24, 6
    toks = _tokens(cfg, 2, pre + steps, 2)
    jpre, jcaches = jax.jit(jlm.prefill, static_argnames=("max_len",))(
        params, {"tokens": jnp.asarray(toks[:, :pre])}, max_len=pre + steps)
    tpre, tcaches = lm.prefill({"tokens": torch.from_numpy(toks[:, :pre])},
                               max_len=pre + steps)
    _close(tpre, jpre, "prefill")
    carried = convert.lm_caches_from_reference(
        jax.tree_util.tree_map(np.asarray, jcaches), cfg)
    assert len(carried) == len(tcaches) == cfg.num_layers
    for i, (a, b) in enumerate(zip(carried, tcaches)):
        assert torch.equal(a["kv"].positions, b["kv"].positions), i
        assert a["kv"].k.shape == b["kv"].k.shape
        for x, y in ((a["kv"].k, b["kv"].k), (a["kv"].v, b["kv"].v)):
            assert float((x - y).abs().max()) <= 1e-4 * float(x.abs().max())
    if cfg.pattern_for_layer(0) == "attn_local":     # the ring buffer
        assert tcaches[0]["kv"].k.shape[1] == cfg.local_window < pre
    dstep = jax.jit(jlm.decode_step)
    for t in range(pre, pre + steps):
        tok = toks[:, t:t + 1]
        want, jcaches = dstep(params, jcaches, jnp.asarray(tok),
                              jnp.asarray(t, jnp.int32))
        got, tcaches = lm.decode_step(tcaches, torch.from_numpy(tok), t)
        got2, carried = lm.decode_step(carried, torch.from_numpy(tok), t)
        _close(got, want, f"decode {t}")
        _close(got2, want, f"decode {t} from the reference's caches")
    jpos = jax.tree_util.tree_map(np.asarray, jcaches)
    for a, b in zip(convert.lm_caches_from_reference(jpos, cfg), tcaches):
        assert torch.equal(a["kv"].positions, b["kv"].positions)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own prefill + token-by-token decode reproduces its full
    forward, at the reference test's bar."""
    _, _, lm = _models(arch)
    S, pre = 24, 18
    toks = torch.from_numpy(_tokens(lm.cfg, 2, S, 1))
    full, _ = lm({"tokens": toks})
    _, caches = lm.prefill({"tokens": toks[:, :pre]}, max_len=S)
    errs = []
    for t in range(pre, S):
        dl, caches = lm.decode_step(caches, toks[:, t:t + 1], t)
        errs.append(float((dl[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / (float(full.abs().max()) + 1e-6) < DECODE_RTOL


def test_init_caches_match_reference_shapes():
    for arch in ARCHS:
        jlm, _, lm = _models(arch)
        jc = jlm.init_caches(3, 40)
        ours = lm.init_caches(3, 40)
        theirs = convert.lm_caches_from_reference(
            jax.tree_util.tree_map(np.asarray, jc), lm.cfg)
        for a, b in zip(ours, theirs):
            assert a["kv"].k.shape == b["kv"].k.shape
            assert torch.equal(a["kv"].positions, b["kv"].positions)


def test_init_is_seeded():
    cfg = get_config("internlm2-1.8b", smoke=True)
    a = LM(cfg, device="cpu", seed=3).state_dict()
    b = LM(cfg, device="cpu", seed=3).state_dict()
    c = LM(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed.embedding"], c["embed.embedding"])
    std = float(a["layers.0.mix.wq"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


# --- the micro-batcher (tests/test_serve.py's, on the port) -------------------

def _echo_dispatch(batch):
    # row-shaped output scatters; scalar + python outputs fan out
    return np.asarray(batch) * 2.0, np.float32(7.0), 42


def test_batcher_scatter_matches_per_request():
    mb = MicroBatcher(_echo_dispatch)
    rng = np.random.default_rng(0)
    reqs = [np.asarray(rng.normal(size=(n, 3)), np.float32)
            for n in (1, 4, 2, 8)]
    tickets = [mb.submit(q) for q in reqs]
    assert mb.flush() == len(reqs)
    for q, tk in zip(reqs, tickets):
        rows, scalar, tag = tk.result(timeout=5)
        assert np.array_equal(rows, q * 2.0)
        assert scalar == np.float32(7.0) and tag == 42
    assert mb.flush() == 0


def test_batcher_scatters_tensors_after_one_host_read():
    mb = MicroBatcher(lambda b: (torch.as_tensor(b) + 1,
                                 torch.tensor(True)))
    reqs = [torch.arange(6.0).view(3, 2), np.ones((1, 2), np.float32)]
    tickets = [mb.submit(q) for q in reqs]
    mb.flush()
    rows0, flag0 = tickets[0].result(timeout=5)
    rows1, flag1 = tickets[1].result(timeout=5)
    assert torch.equal(rows0, torch.arange(6.0).view(3, 2) + 1)
    assert torch.equal(rows1, torch.full((1, 2), 2.0))
    assert bool(flag0) and bool(flag1) and rows0.device.type == "cpu"


def test_batcher_failed_batch_rejects_every_ticket():
    def boom(batch):
        raise RuntimeError("kernel exploded")
    mb = MicroBatcher(boom)
    tickets = [mb.submit(np.zeros((2, 3), np.float32)) for _ in range(3)]
    with pytest.raises(RuntimeError, match="exploded"):
        mb.flush()
    for tk in tickets:
        assert tk.done()
        with pytest.raises(RuntimeError, match="exploded"):
            tk.result(timeout=1)


def test_batcher_background_window_loop_serves_and_stops():
    mb = MicroBatcher(_echo_dispatch, window_s=0.005)
    mb.start()
    try:
        assert mb.running
        q = np.ones((3, 2), np.float32)
        out = [mb.submit(q).result(timeout=10) for _ in range(4)]
        assert all(np.array_equal(rows, q * 2.0) for rows, _, _ in out)
    finally:
        mb.stop()
    assert not mb.running


def test_batcher_submit_rejects_non_batches():
    mb = MicroBatcher(_echo_dispatch)
    with pytest.raises(ValueError, match="rows, features"):
        mb.submit(np.zeros((3,), np.float32))


# --- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("arch,prompt", [
    ("internlm2-1.8b", 8), ("gemma3-4b", 20), ("minicpm-2b", 8),
    ("nemotron-4-15b", 8), ("mamba2-1.3b", 8), ("recurrentgemma-9b", 20),
    ("olmoe-1b-7b", 8), ("llama4-maverick-400b-a17b", 8),
    ("whisper-medium", 8), ("qwen2-vl-7b", 20)])
def test_launcher_serves_on_cpu(arch, prompt, capsys):
    out = t_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--batch", "2", "--gen", "4",
                        "--prompt-len", str(prompt)])
    text = capsys.readouterr().out
    assert "served 2/2" in text and "CPU" in text
    assert out["served"] == 2 and out["tokens"] == 8 and out["finite"]
    assert out["decode_steps"] == 3 and len(out["prefill_s"]) == 1
    assert out["generated"].shape == (2, 4)
    assert len(out["prefill_ms"]) == 1 and out["tokens_per_s"] > 0
    assert sum(out["flash_launches"].values()) == 0     # the CPU route
    # the launcher's greedy tokens are the model's own greedy decode
    cfg = get_config(arch, smoke=True)
    lm = LM(cfg, device="cpu", seed=0)
    batch = t_serve.frontend_inputs(cfg, 2, "cpu")
    batch["tokens"] = torch.from_numpy(out["prompts"]).to(torch.int32)
    logits, caches = lm.prefill(batch, max_len=prompt + 4)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    gen = [tok]
    for t in range(prompt, prompt + 3):
        logits, caches = lm.decode_step(caches, tok, t)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        gen.append(tok)
    np.testing.assert_array_equal(torch.cat(gen, 1).numpy(),
                                  out["generated"])


def test_launcher_tail_wave_and_no_smoke_flag(capsys):
    out = t_serve.main(["--arch", "internlm2-1.8b", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--gen", "2",
                        "--prompt-len", "5"])
    assert "served 3/3" in capsys.readouterr().out
    assert out["generated"].shape == (3, 2)
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            t_serve.main(["--arch", "internlm2-1.8b", "--no-smoke",
                          "--requests", "0"])
