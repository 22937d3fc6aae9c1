"""The f32 flash kernel's walk, on the CPU.

``flash_f32_kernel`` (f32 at Sq > 16) packs ``hb`` query heads of a GQA
group x ``pb`` positions into a block (``flash_attention.f32_tiles``),
skips the KV tiles ``live_tiles`` calls DEAD for the block's positions,
masks only LIVE ones, and runs the online softmax tile by tile;
``flash_attention.flash_f32_walk_plain`` states that walk in PyTorch.
Here the walk is held to the reference Pallas kernel in interpret mode at
f32 under the reference test's f32 bar (rtol 1e-3, atol 2e-6:
``tests/test_torch_flash.py``'s f32 cases) for causal, windowed,
shuffled, holed and non-monotone positions, GQA groups 1, 2, 3, 4 and 8,
head dims 64, 128 and 256 (and 32, padded), ragged Sq and Skv, and rows
with no valid key (the mean of v; zero with ``zero_empty_rows``, against
the plain version). Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

F32_RTOL, F32_ATOL = 1e-3, 2e-6   # the reference test's f32 bar
NEG_POS = -(1 << 30)


def _qkv(rng, b, h, kv, sq, skv, hd):
    q = (rng.normal(size=(b, h, sq, hd)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, kv, skv, hd)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, kv, skv, hd)).astype(np.float32)
    return q, k, v


def _reference(q, k, v, qp, kp, causal, window):
    out = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                  window=window, block_q=q.shape[2], block_k=k.shape[2],
                  interpret=True)
    return np.asarray(out)


def _walk(q, k, v, qp, kp, causal, window, zero=False):
    t = torch.from_numpy
    return fa.flash_f32_walk_plain(t(q), t(k), t(v), t(qp), t(kp),
                                   causal=causal, window=window,
                                   zero_empty_rows=zero).numpy()


def _positions(rng, n, kind):
    p = np.arange(n, dtype=np.int32)
    if kind in ("shuffled", "holes"):
        p = rng.permutation(p).astype(np.int32)
    if kind == "holes":
        p[rng.random(n) < 0.2] = NEG_POS
    return p


CASES = {  # name: (b, h, kv, sq, skv, hd, qpos kind, kpos kind, causal, window)
    "causal_g2": (1, 4, 2, 300, 300, 64, "ordered", "ordered", True, 0),
    "window_g2": (1, 4, 2, 257, 257, 64, "ordered", "ordered", True, 100),
    "full_g1": (1, 2, 2, 100, 140, 64, "ordered", "ordered", False, 0),
    "shuffled_kpos_g4": (1, 8, 2, 200, 200, 64, "ordered", "shuffled", True,
                         0),
    "holes_window_g8": (1, 8, 1, 150, 150, 64, "ordered", "holes", True, 60),
    "non_monotone_qpos_g3": (1, 6, 2, 90, 130, 64, "shuffled", "ordered",
                             True, 0),
    "hd128_g2": (1, 4, 2, 140, 140, 128, "ordered", "ordered", True, 0),
    "hd256_g2": (1, 4, 2, 100, 100, 256, "ordered", "ordered", True, 0),
    "hd32_padded": (1, 2, 1, 70, 70, 32, "ordered", "ordered", True, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_matches_reference_kernel(name):
    b, h, kv, sq, skv, hd, qk, kk, causal, window = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q, k, v = _qkv(rng, b, h, kv, sq, skv, hd)
    qp = _positions(rng, sq, qk) + (skv - sq if qk == "ordered" else 0)
    kp = _positions(rng, skv, kk)
    got = _walk(q, k, v, qp, kp, causal, window)
    want = _reference(q, k, v, qp, kp, causal, window)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)


def test_walk_skips_dead_tiles():
    """At a causal prefill most tiles above the diagonal are DEAD for the
    kernel's blocks; the walk skips them and its result is unchanged."""
    hb, pb, bk = fa.f32_tiles(128, 2)
    assert (hb, pb, bk) == (2, 64, 64)
    pos = torch.arange(512)
    cls = fa.live_tiles(pos, pos, pb, bk, True, 0)
    n = cls.numel()
    assert int((cls == fa.DEAD).sum()) == n // 2 - cls.shape[0] // 2 \
        and int((cls == fa.LIVE).sum()) == cls.shape[0]


@pytest.mark.parametrize("group,want", [(1, 1), (2, 2), (3, 1), (4, 4),
                                        (6, 2), (8, 8), (16, 8)])
def test_f32_tiles_packing(group, want):
    """A block packs the largest power of two of heads that divides the
    group, at most 8, into 128 rows (64 at head dim 256)."""
    for hd, rows, bk in ((64, 128, 64), (128, 128, 64), (256, 64, 32)):
        hb, pb, k = fa.f32_tiles(hd, group)
        assert hb == want and hb * pb == rows and k == bk


@pytest.mark.parametrize("group", [1, 2, 4])
def test_walk_masked_rows(group):
    """Rows with no valid key: the mean of v over all keys (the reference
    kernel's result), zero with ``zero_empty_rows`` (against the plain
    version); every other row as the reference."""
    rng = np.random.default_rng(group)
    kv, sq, hd = 2, 160, 64
    q, k, v = _qkv(rng, 1, kv * group, kv, sq, sq, hd)
    qp = np.arange(sq, dtype=np.int32)
    qp[[0, 70, 159]] = -5                        # sees no key
    kp = np.arange(sq, dtype=np.int32)
    got = _walk(q, k, v, qp, kp, True, 0)
    want = _reference(q, k, v, qp, kp, True, 0)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    mean_v = np.repeat(v.mean(axis=2), group, axis=1)
    np.testing.assert_allclose(got[:, :, 70], mean_v, rtol=F32_RTOL,
                               atol=1e-5)
    zero = _walk(q, k, v, qp, kp, True, 0, zero=True)
    t = torch.from_numpy
    plain = fa.flash_attention_plain(t(q), t(k), t(v), t(qp), t(kp),
                                     zero_empty_rows=True).numpy()
    assert (zero[:, :, [0, 70, 159]] == 0).all()
    np.testing.assert_allclose(zero, plain, rtol=F32_RTOL, atol=F32_ATOL)
