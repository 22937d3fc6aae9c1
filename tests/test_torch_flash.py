"""The port's flash attention and ``attend`` against the reference, on the CPU.

On CPU tensors ``repro_torch.kernels.flash_attention.flash_attention`` runs
its plain version (the full masked softmax with the kernel's finite NEG);
it is held to the reference Pallas kernel in interpret mode at the
reference test's grid and tolerances (f32: rtol 1e-3, atol 2e-6; bf16:
atol 2e-2, the bf16 rounding of p that only the kernel does). ``attend``
is held to the reference's at a sequence above ``Q_CHUNK`` with a tail
chunk. The kernel route of ``attend`` (``_attend_kernel``: scaling, the
transposed views, the zeroing of rows with no valid key) runs here too,
on the plain version. Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

F32_RTOL, F32_ATOL = 1e-3, 2e-6   # the reference test's f32 bar
BF16_ATOL = 2e-2                  # and its bf16 bar


def _qkv(seed, b, h, kv, s, hd, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    q = (rng.normal(size=(b, h, s, hd)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, kv, skv, hd)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, kv, skv, hd)).astype(np.float32)
    return q, k, v


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference_kernel(causal, window, dtype):
    B, H, KV, S, HD = 1, 4, 2, 512, 64
    q, k, v = _qkv(0, B, H, KV, S, HD)
    pos = np.arange(S, dtype=np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_flash(_to_jax(q, jd), _to_jax(k, jd), _to_jax(v, jd),
                   jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                   window=window, block_q=128, block_k=128, interpret=True)
    got = fa.flash_attention(_to_torch(q, td), _to_torch(k, td),
                             _to_torch(v, td), torch.from_numpy(pos),
                             torch.from_numpy(pos), causal=causal,
                             window=window)
    assert got.dtype == td and got.shape == (B, H, S, HD)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=F32_RTOL, atol=atol)


def test_flash_padded_keys_masked():
    """Keys padded with kpos = -1 (and junk values) change nothing, in
    both packages; the port needs no padding to a tile at all."""
    B, H, KV, S, HD = 1, 2, 1, 256, 32
    q, k, v = _qkv(4, B, H, KV, S, HD)
    pos = np.arange(S, dtype=np.int32)
    kp = np.pad(k, ((0, 0), (0, 0), (0, S), (0, 0)), constant_values=3.0)
    vp = np.pad(v, ((0, 0), (0, 0), (0, S), (0, 0)), constant_values=3.0)
    kpos = np.concatenate([pos, np.full(S, -1, np.int32)])
    want = j_flash(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(pos), jnp.asarray(kpos), causal=True,
                   block_q=128, block_k=128, interpret=True)
    t = torch.from_numpy
    got = fa.flash_attention(t(q), t(kp), t(vp), t(pos), t(kpos))
    base = fa.flash_attention(t(q), t(k), t(v), t(pos), t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_fully_masked_row_is_mean_of_v():
    """A query row with no valid key: the reference kernel's finite NEG
    gives every key p = 1, so both return the mean of v over all keys."""
    B, H, KV, S, HD = 1, 4, 2, 256, 32
    q, k, v = _qkv(7, B, H, KV, S, HD)
    qpos = np.arange(S, dtype=np.int32)
    kpos = qpos + 1                    # query 0 sees no key
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(qpos), jnp.asarray(kpos), causal=True,
                   block_q=128, block_k=128, interpret=True)
    t = torch.from_numpy
    got = fa.flash_attention(t(q), t(k), t(v), t(qpos), t(kpos))
    mean_v = np.repeat(v.mean(axis=2), H // KV, axis=1)      # (B, H, hd)
    np.testing.assert_allclose(np.asarray(want)[:, :, 0], mean_v, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[:, :, 0], mean_v, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_RTOL, atol=1e-5)


def test_flash_counts_no_launch_on_cpu_and_checks_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 4, 2, 32, 16))
    pos = torch.arange(32)
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v, pos, pos)
    assert fa.flash_attention.launches == before
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention(q, k[:, :1].expand(1, 3, 32, 16).contiguous(),
                           v[:, :1].expand(1, 3, 32, 16).contiguous(), pos,
                           pos)
    with pytest.raises(ValueError, match="positions"):
        fa.flash_attention(q, k, v, pos[:5], pos)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, pos, pos, window=-1)
    meta = torch.empty((1, 4, 32, 16), device="meta")
    with pytest.raises(RuntimeError, match="CPU or on one CUDA"):
        fa.flash_attention(meta, k, v, pos, pos)


def test_flash_zero_empty_rows():
    """``zero_empty_rows`` (``attend``'s contract) writes zero for exactly
    the rows with no valid key and leaves every other row as it was."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 4, 2, 64, 32))
    qpos = torch.arange(64)
    kpos = qpos + 3                        # queries 0..2 see no key
    kpos[-5:] = t_attn.NEG_POS             # cold slots
    mean = fa.flash_attention(q, k, v, qpos, kpos)
    zero = fa.flash_attention(q, k, v, qpos, kpos, zero_empty_rows=True)
    assert torch.all(zero[:, :, :3] == 0)
    assert torch.all(mean[:, :, :3].abs().amax(dim=-1) > 0)
    assert torch.equal(zero[:, :, 3:], mean[:, :, 3:])


def _c_params(source: str, fn: str) -> list[str]:
    """The parameter types of ``fn`` as declared in ``csrc/<source>.cu``."""
    import re
    text = (_build.CSRC / f"{source}.cu").read_text()
    decl = re.search(rf"\bint {fn}\(([^)]*)\)", text)
    assert decl, f"{fn} not declared in {source}.cu"
    return [" ".join(p.split()[:-1]) for p in decl.group(1).split(",")]


@pytest.mark.parametrize("source,fn", [
    (source, fn) for source, sigs in _build.SOURCES.items() for fn in sigs])
def test_ctypes_signature_matches_c_declaration(source, fn):
    """Each ctypes argtypes list of ``kernels/_build.py`` has the arity and
    the types of its C entry point, so a changed C signature cannot be
    called with shifted arguments on the card."""
    import ctypes

    def kind(c_type: str):
        if "*" in c_type:
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "float": ctypes.c_float,
                "long long": ctypes.c_longlong}[c_type]
    assert [kind(t) for t in _c_params(source, fn)] == \
        list(_build.SOURCES[source][fn])


# --- attend -----------------------------------------------------------------

S_LONG = t_attn.Q_CHUNK + 200      # two chunks: a full one and a tail


def _attend_inputs(seed, b, sq, h, kv, hd, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    return q, k, v


def _both_attend(q, k, v, qpos, kpos, causal, window):
    want = j_attn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         q_positions=jnp.asarray(qpos),
                         kv_positions=jnp.asarray(kpos), causal=causal,
                         window=window)
    t = torch.from_numpy
    got = t_attn.attend(t(q), t(k), t(v), q_positions=t(qpos),
                        kv_positions=t(kpos), causal=causal, window=window)
    kern = t_attn._attend_kernel(t(q), t(k), t(v), q_positions=t(qpos),
                                 kv_positions=t(kpos), causal=causal,
                                 window=window)
    return np.asarray(want), got.numpy(), kern.numpy()


@pytest.mark.parametrize("case", ["causal", "window", "cross"])
def test_attend_matches_reference(case):
    """The chunked CPU route against the reference's, and the kernel route
    (on the plain version here) against both, at S above Q_CHUNK."""
    causal, window = {"causal": (True, 0), "window": (True, 100),
                      "cross": (False, 0)}[case]
    skv = 300 if case == "cross" else S_LONG
    q, k, v = _attend_inputs(3, 2, S_LONG, 4, 2, 16, skv)
    qpos = np.arange(S_LONG, dtype=np.int32)
    kpos = np.arange(skv, dtype=np.int32)
    if case == "cross":
        qpos, kpos = np.zeros_like(qpos), np.zeros_like(kpos)
    want, got, kern = _both_attend(q, k, v, qpos, kpos, causal, window)
    assert got.shape == want.shape == (2, S_LONG, 4, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(kern, want, rtol=1e-4, atol=1e-5)


def test_attend_fully_masked_rows_are_zero():
    """Cold ring slots (NEG_POS) and a query before every key: both
    packages return zero for such a row, on both of the port's routes."""
    q, k, v = _attend_inputs(5, 1, 3, 4, 2, 16, skv=8)
    kpos = np.array([5, 6, 7] + [t_attn.NEG_POS] * 5, np.int32)
    qpos = np.array([4, 5, 7], np.int32)            # query 4 sees nothing
    want, got, kern = _both_attend(q, k, v, qpos, kpos, True, 0)
    assert np.all(want[:, 0] == 0) and np.all(got[:, 0] == 0) \
        and np.all(kern[:, 0] == 0)
    assert np.abs(want[:, 1:]).min() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(kern, want, rtol=1e-4, atol=1e-6)


def test_attend_decode_shape_window():
    """One query against a ring buffer (decode of a local layer)."""
    q, k, v = _attend_inputs(6, 2, 1, 4, 2, 16, skv=16)
    kpos = np.arange(24, 40, dtype=np.int32)
    qpos = np.array([39], np.int32)
    want, got, kern = _both_attend(q, k, v, qpos, kpos, True, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(kern, want, rtol=1e-4, atol=1e-6)


def test_apply_attention_cross_matches_reference():
    """Cross-attention (``kv_input``: every encoder frame visible, no rope,
    no cache) through the whole block, with the same projections."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    cfg = get_config("internlm2-1.8b", smoke=True)
    jcfg = j_get_config("internlm2-1.8b", smoke=True)
    rng = np.random.default_rng(8)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    w = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
         "wo": (h, hd, d)}
    w = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in w.items()}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    enc = rng.normal(size=(2, 11, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want, _ = j_attn.apply_attention(
        jcfg, {n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x),
        positions=jnp.asarray(pos), kv_input=jnp.asarray(enc))
    t = torch.from_numpy
    got, cache = t_attn.apply_attention(
        cfg, {n: t(a) for n, a in w.items()}, t(x),
        positions=t(pos.copy()), kv_input=t(enc))
    assert cache is None and got.shape == (2, 7, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
