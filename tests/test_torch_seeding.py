"""Port vs reference for the fused k-means++ seeding, on the CPU.

The port cannot reproduce ``jax.random``, so the tests compute the
reference's own draws (its ``_draws`` protocol: ``split``, ``randint`` for
the first row, ``uniform`` for the K - 1 rounds) and feed them to the
port's draw-consuming core; it must choose exactly the reference's rows.
One round agrees with the reference's kernel (interpret mode) and its twin
to 1e-5 of the scale of ``xn`` (the cross-term form cancels, so a relative
bound on small d2 would be wrong); tile sums to rtol 1e-5. The port's own
draws are held to their properties.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.batch import BatchedKMeans as JBatchedKMeans  # noqa: E402
from repro.kernels import kmeanspp_init as jk  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.batch import BatchedKMeans  # noqa: E402
from repro_torch.kernels import kmeanspp_init as kpp  # noqa: E402

# the reference's tests/test_seeding.py:91-95 shapes: (b, n, f, k, block_n)
FUSED_SHAPES = [(4, 600, 48, 9, 256), (3, 200, 16, 5, 512),
                (2, 1024, 128, 8, 128)]


def _stack(b, n, f, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (b, n, f),
                                      jnp.float32))


def _keys(b, base=0):
    return jax.vmap(jax.random.PRNGKey)(base + jnp.arange(b))


def _ref_draws(keys, n, k):
    """The reference's per-problem draws (``_init_impl``'s ``_draws``)."""
    def one(key):
        k0, ku = jax.random.split(key)
        return (jax.random.randint(k0, (), 0, n),
                jax.random.uniform(ku, (k - 1,)))
    i0, us = jax.vmap(one)(keys)
    return torch.from_numpy(np.array(i0)), torch.from_numpy(np.array(us))


def _round_inputs(b, n, f, bn, seed=0):
    """Shared inputs of a second round: padded rows, norms, a centroid per
    problem and the running minimum after a first round."""
    np_ = -(-n // bn) * bn
    x = np.zeros((b, np_, 128), np.float32)       # reference kernel: Fp 128
    x[:, :n, :f] = _stack(b, n, f, seed)
    xn = (x * x).sum(2)
    d2 = np.where(np.arange(np_) < n, np.inf, 0.0).astype(np.float32)
    d2 = np.broadcast_to(d2, (b, np_)).copy()
    d2, _ = jk._round_twin(jnp.asarray(x), jnp.asarray(xn),
                           jnp.asarray(x[:, 1:2]), jnp.asarray(d2),
                           block_n=bn)
    return x, xn, np.ascontiguousarray(x[:, n // 2:n // 2 + 1]), \
        np.array(d2)


@pytest.mark.parametrize("b,n,f,bn", [(3, 600, 48, 256), (2, 200, 16, 256),
                                      (2, 1024, 128, 128)])
def test_round_matches_reference_kernel_and_twin(b, n, f, bn):
    x, xn, c, d2 = _round_inputs(b, n, f, bn)
    got_d2, got_ts = kpp.kmeanspp_round(*map(torch.from_numpy,
                                             (x, xn, c, d2)), block_n=bn)
    args = tuple(map(jnp.asarray, (x, xn, c, d2)))
    scale = 1e-5 * float(xn.max())
    for want_d2, want_ts in (jk.kmeanspp_round(*args, block_n=bn,
                                               interpret=True),
                             jk._round_twin(*args, block_n=bn)):
        np.testing.assert_allclose(got_d2.numpy(), np.asarray(want_d2),
                                   rtol=0, atol=scale)
        np.testing.assert_allclose(got_ts.numpy(), np.asarray(want_ts),
                                   rtol=1e-5)
    assert (got_d2.numpy()[:, n:] == 0).all()


@pytest.mark.parametrize("t", [1, 4])
def test_select_index_is_reference(t):
    """Selection from shared (d2, tile sums, u) is exactly the reference's,
    through both branches (one tile, several tiles); zero-mass rows are
    never chosen."""
    rng = np.random.default_rng(t)
    b, bn = 5, 128
    n = t * bn - 37
    d2 = rng.exponential(size=(b, t * bn)).astype(np.float32)
    d2[:, n:] = 0.0
    d2[:, ::7] = 0.0                                 # already chosen rows
    ts = d2.reshape(b, t, bn).sum(2)
    for u in (rng.uniform(size=b), np.array([0.0, 1e-9, 0.5, 1 - 1e-7,
                                             0.999999])):
        u = u.astype(np.float32)
        got = kpp.select_index(*map(torch.from_numpy, (d2, ts, u)), bn, n)
        want = jk._select_index(*map(jnp.asarray, (d2, ts, u)), bn, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (d2[np.arange(b), got.numpy()] > 0).all()


@pytest.mark.parametrize("b,n,f,k,block_n", FUSED_SHAPES)
def test_seeding_from_reference_draws_chooses_reference_rows(b, n, f, k,
                                                             block_n):
    x, keys = _stack(b, n, f), _keys(b)
    i0, us = _ref_draws(keys, n, k)
    idx = kpp.seed_indices(torch.from_numpy(x), i0, us, k,
                           kpp.clamp_init_block(n, block_n))
    got = np.take_along_axis(x, idx.numpy()[..., None], axis=1)
    twin = jk.init_kmeanspp_fused(keys, jnp.asarray(x), k, block_n=block_n,
                                  use_kernel=False)
    kern = jk.init_kmeanspp_fused(keys, jnp.asarray(x), k, block_n=block_n,
                                  use_kernel=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(twin))
    np.testing.assert_array_equal(got, np.asarray(kern))


def test_clamp_init_block_is_reference():
    for n in (1, 127, 128, 200, 600, 4096, 70_000):
        for bn in (64, 128, 300, 512, 100_000):
            assert kpp.clamp_init_block(n, bn) == jk.clamp_init_block(n, bn)
    assert hw.INIT_BLOCK_N == jk.DEFAULT_BLOCK_N


def _rows_of(x, c):
    return (c[:, None, :] == x[None, :, :]).all(-1).any(1)


def test_seeds_are_distinct_real_rows_and_deterministic():
    b, n, f, k = 6, 500, 32, 11
    x = torch.from_numpy(_stack(b, n, f, seed=1))
    c1 = kpp.init_kmeanspp_fused(x, k, range(b))
    c2 = kpp.init_kmeanspp_fused(x, k, range(b))
    assert torch.equal(c1, c2)
    assert not torch.equal(c1, kpp.init_kmeanspp_fused(x, k, range(1, b + 1)))
    for p in range(b):
        assert bool(_rows_of(x[p], c1[p]).all())
        assert torch.unique(c1[p], dim=0).shape[0] == k


def test_problem_seeds_do_not_depend_on_batch():
    """Problem b draws from its own generator: the same seeds at B = 1 and
    B = 4."""
    x = torch.from_numpy(_stack(4, 400, 16, seed=2))
    full = BatchedKMeans(6, init="kmeans++-fused", random_state=7,
                         device="cpu").init_centroids(x)
    for p in range(4):
        one = BatchedKMeans(6, init="kmeans++-fused", random_state=7 + p,
                            device="cpu").init_centroids(x[p:p + 1])
        assert torch.equal(one[0], full[p])


@pytest.mark.parametrize("block_n", [128, 256, 1024])
def test_no_padded_row_drawn(block_n):
    """The tile size shapes the CDF, never its support: every pick is a
    real row whatever the padding."""
    b, n, f, k = 3, 700, 24, 8
    x = torch.from_numpy(_stack(b, n, f, seed=3))
    c = kpp.init_kmeanspp_fused(x, k, range(b), block_n=block_n)
    for p in range(b):
        assert bool(_rows_of(x[p], c[p]).all()), f"block_n={block_n}"


@pytest.mark.parametrize("init", ["kmeans++", "kmeans++-fused", "random"])
def test_fit_deterministic_per_random_state(init):
    x = _stack(4, 256, 8, seed=3)
    r1 = BatchedKMeans(4, random_state=0, max_iter=5, init=init,
                       device="cpu").fit(x)
    r2 = BatchedKMeans(4, random_state=0, max_iter=5, init=init,
                       device="cpu").fit(x)
    assert torch.equal(r1.cluster_centers_, r2.cluster_centers_)
    assert torch.equal(r1.labels_, r2.labels_)


def test_fused_init_reproducible_like_reference():
    """Both packages: the same random_state gives the same seeds, another
    gives other seeds (the reference's own contract,
    tests/test_seeding.py:145)."""
    x = _stack(5, 300, 16, seed=7)
    for make, equal in (
            (lambda rs: JBatchedKMeans(n_clusters=6, random_state=rs,
                                       init="kmeans++-fused"),
             lambda a, b: bool(jnp.array_equal(a, b))),
            (lambda rs: BatchedKMeans(6, random_state=rs,
                                      init="kmeans++-fused", device="cpu"),
             torch.equal)):
        a = make(11).init_centroids(x)
        assert equal(a, make(11).init_centroids(x))
        assert not equal(a, make(12).init_centroids(x))
