"""The flash kernels' tile rule and the decode kernel's split walk, on the CPU.

``repro_torch.kernels.flash_attention`` states in plain PyTorch the two
rules its CUDA kernels follow (nothing on the card's path calls them):
``live_tiles``, which (query tile, KV tile) pairs the kernels skip (DEAD)
or leave unmasked (FULL), and ``flash_split_plain``, the decode kernel's
walk (KV splits, per-split (m, l, acc), the fallback of a row with no valid
key in a split, the combine). Here the tile rule is held, on random
positions with holes, shuffles, windows and ragged lengths, to never drop a
valid (query, key) pair and to call FULL only tiles with no masked pair;
the split walk is held to the reference Pallas kernel in interpret mode at
decode shapes (GQA groups 1, 2 and 4, Sq from 1 to 16, ragged Skv, cold
ring slots, a window, rows with no valid key under both ``zero_empty``
settings): f32 within rtol 1e-5 (atol 1e-6 for outputs near zero: the two
walks sum in another order); bf16 within the reference test's bf16 bar
(atol 2e-2, rtol 1e-3), since each rounds p to bf16 against its own running
max. Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:       # deterministic fallback (see _hypothesis_stub)
    from _hypothesis_stub import given, settings, st

from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

NEG_POS = -(1 << 30)            # an empty cache slot (models.attention)
F32_RTOL, F32_ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL = 1e-3, 2e-2


def _positions(rng, n: int, kind: str) -> np.ndarray:
    """n key positions: in order, shuffled, or shuffled with -1 / NEG_POS
    holes."""
    p = np.arange(n, dtype=np.int32) + int(rng.integers(0, 40))
    if kind != "ordered":
        p = rng.permutation(p)
    if kind == "holes":
        holes = rng.random(n) < 0.3
        p[holes] = rng.choice([-1, NEG_POS], size=int(holes.sum()))
    return p


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 40), st.integers(1, 80),
       st.integers(1, 16), st.integers(1, 16),
       st.sampled_from(["ordered", "shuffled", "holes"]),
       st.sampled_from([0, 1, 7, 30]), st.sampled_from([True, False]))
def test_live_tiles_keeps_every_valid_pair(seed, sq, skv, block_q, block_k,
                                           kind, window, causal):
    """A DEAD pair of tiles holds no valid (query, key) pair; a FULL one
    holds block_k existing keys, each valid for every query of the tile."""
    rng = np.random.default_rng(seed)
    kpos = torch.from_numpy(_positions(rng, skv, kind))
    qpos = torch.from_numpy(rng.integers(-5, skv + 45, size=sq)
                            .astype(np.int32))          # non-monotone
    cls = fa.live_tiles(qpos, kpos, block_q, block_k, causal, window)
    assert cls.shape == (-(-sq // block_q), -(-skv // block_k))
    mask = fa.position_mask(qpos, kpos, causal, window).numpy()
    tiles = cls.numpy()
    qi, kj = np.nonzero(mask)
    assert (tiles[qi // block_q, kj // block_k] != fa.DEAD).all()
    for a, c in zip(*np.nonzero(tiles == fa.FULL)):
        assert (c + 1) * block_k <= skv
        assert mask[a * block_q:(a + 1) * block_q,
                    c * block_k:(c + 1) * block_k].all()


def test_live_tiles_causal_prefill_skips_half():
    """In-order causal prefill: the tiles past the diagonal are DEAD, the
    ones below it FULL, the diagonal LIVE; a window kills the far past."""
    pos = torch.arange(256)
    cls = fa.live_tiles(pos, pos, 64, 64, True, 0)
    want = torch.tensor([[1, 0, 0, 0], [2, 1, 0, 0], [2, 2, 1, 0],
                         [2, 2, 2, 1]], dtype=torch.int8)
    assert torch.equal(cls, want)
    win = fa.live_tiles(pos, pos, 64, 64, True, 64)
    assert (win[3, :2] == fa.DEAD).all() and win[3, 2] == fa.LIVE
    assert not (win == fa.FULL).any()
    cold = pos.clone()
    cold[128:] = NEG_POS                       # a ring's cold slots
    assert (fa.live_tiles(pos, cold, 256, 64, True, 0)[0, 2:] == fa.DEAD).all()


@pytest.mark.parametrize("sq,dtype,want", [
    (1, torch.bfloat16, "flash_decode_kernel"),
    (hw.FLASH_DECODE_MAX_SQ, torch.float32, "flash_decode_kernel"),
    (hw.FLASH_DECODE_MAX_SQ + 1, torch.float16, "flash_prefill_kernel"),
    (hw.FLASH_DECODE_MAX_SQ + 1, torch.float32, "flash_f32_kernel")])
def test_kernel_for_follows_sq_and_dtype(sq, dtype, want):
    assert fa.kernel_for(sq, dtype) == want
    assert want in fa.flash_attention.kernel_launches


CASES = {
    # name: (Skv, kpos, qpos(sq), causal, window)
    "ragged_causal": (77, lambda s: np.arange(s), lambda sq: 76 - sq
                      + np.arange(1, sq + 1), True, 0),
    "cold_ring": (96, lambda s: np.where(np.arange(s) < 60, np.arange(s),
                                         NEG_POS),
                  lambda sq: 59 - sq + np.arange(1, sq + 1), True, 0),
    "window": (130, lambda s: (np.arange(s) * 7919) % s,
               lambda sq: 129 - sq + np.arange(1, sq + 1), True, 40),
    "empty_rows": (50, lambda s: np.arange(s) + 10,
                   lambda sq: np.arange(sq) * 5 - 3, True, 0),
}


def _decode_inputs(seed, g, sq, case, hd=32, b=2, kv=2):
    skv, kpos, qpos, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, kv * g, sq, hd)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, kv, skv, hd)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, kv, skv, hd)).astype(np.float32)
    return (q, k, v, qpos(sq).astype(np.int32), kpos(skv).astype(np.int32),
            causal, window)


def _reference(q, k, v, qp, kp, causal, window, dtype):
    """The reference kernel, one grid tile over the whole (Sq, Skv)."""
    jd = getattr(jnp, dtype)
    out = j_flash(jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd),
                  jnp.asarray(v).astype(jd), jnp.asarray(qp),
                  jnp.asarray(kp), causal=causal, window=window,
                  block_q=q.shape[2], block_k=k.shape[2], interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("sq", [1, 5, 16])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_split_walk_matches_reference(g, sq, case):
    """The decode kernel's split walk at 1, 3 and 7 splits of 8-key tiles
    against the reference kernel (f32); zero_empty_rows zeroes exactly the
    rows with no valid key."""
    q, k, v, qp, kp, causal, window = _decode_inputs(10 * g + sq, g, sq, case)
    want = _reference(q, k, v, qp, kp, causal, window, "float32")
    t = torch.from_numpy
    empty = ~fa.position_mask(t(qp), t(kp), causal, window).any(1).numpy()
    assert empty.any() == (case == "empty_rows")
    for splits in (1, 3, 7):
        got = fa.flash_split_plain(t(q), t(k), t(v), t(qp), t(kp),
                                   causal=causal, window=window,
                                   splits=splits, block_k=8)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                                   atol=F32_ATOL)
        zero = fa.flash_split_plain(t(q), t(k), t(v), t(qp), t(kp),
                                    causal=causal, window=window,
                                    zero_empty_rows=True, splits=splits,
                                    block_k=8).numpy()
        assert (zero[:, :, empty] == 0).all()
        np.testing.assert_array_equal(zero[:, :, ~empty],
                                      got.numpy()[:, :, ~empty])


@pytest.mark.parametrize("case", ["cold_ring", "empty_rows"])
def test_split_walk_bf16_matches_reference(case):
    """At bf16 (p rounded to bf16 before P V in both walks) within the
    reference test's bf16 bar."""
    q, k, v, qp, kp, causal, window = _decode_inputs(3, 2, 4, case)
    want = _reference(q, k, v, qp, kp, causal, window, "bfloat16")

    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16)
    got = fa.flash_split_plain(bf(q), bf(k), bf(v), torch.from_numpy(qp),
                               torch.from_numpy(kp), causal=causal,
                               window=window, splits=3, block_k=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_split_walk_matches_plain_softmax_at_lm_decode_shape():
    """internlm2-1.8b's decode shape cut in width (group 2, 64 KV tiles of
    32 keys, the last 31 slots cold): the walk at the kernels' own split
    counts equals the plain version's full softmax."""
    rng = np.random.default_rng(5)
    skv = 2080
    q = torch.from_numpy(rng.normal(size=(1, 4, 1, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, skv, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, skv, 16)).astype(np.float32))
    kp = torch.arange(skv, dtype=torch.int32)
    kp[2049:] = NEG_POS
    qp = torch.tensor([2048], dtype=torch.int32)
    want = fa.flash_attention_plain(q, k, v, qp, kp)
    for splits in (9, 33, 64):
        got = fa.flash_split_plain(q, k, v, qp, kp, splits=splits,
                                   block_k=32)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=F32_RTOL, atol=F32_ATOL)
