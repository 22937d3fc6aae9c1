"""Port vs reference, kernel by kernel, on the CPU.

The port's wrappers run their kernels' plain PyTorch versions on CPU
tensors; the reference runs its Pallas kernels in interpret mode. Inputs
are made with numpy from a seed and fed to both, with the same explicit
KernelParams, at small irregular shapes with more than one tile in every
axis. Tolerances: assignments and counts exact; min distances and sums to
rtol 1e-5 of the largest magnitude (the two packages sum f32 products in
different orders); FT detection counts exact for the same descriptor.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import lloyd_step_ft as j_llft  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import lloyd_step_ft as t_llft  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

M, K, F = 517, 260, 200          # 5 x 3 x 2 tiles at (128, 128, 128)
TILES = [(128, 128, 128), (64, 128, 128)]
RTOL = 1e-5


def _blob_inputs(seed=3):
    x, _ = make_blobs(M, F, 9, seed=seed)
    rng = np.random.default_rng(seed)
    c = x[rng.choice(M, K, replace=False)] + rng.normal(
        size=(K, F)).astype(np.float32)
    return x, c.astype(np.float32)


def _tie_inputs(seed=5):
    """Small integers, so every product and sum is exact in f32: centroid
    duplicates across a tile boundary (10 == 200, 127 == 128), inside a tile
    (30 == 31) and in the ragged last tile (259 == 5), and rows sitting on
    them, so the argmin tie-break decides."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, size=(K, F)).astype(np.float32)
    for dup, orig in ((200, 10), (128, 127), (31, 30), (259, 5)):
        c[dup] = c[orig]
    x = rng.integers(-3, 4, size=(M, F)).astype(np.float32)
    for i, orig in enumerate((10, 127, 30, 5) * 18):
        x[7 * i] = c[orig]
    return x, c


def _both(x, c, tiles):
    return (torch.from_numpy(x), torch.from_numpy(c), ops.KernelParams(*tiles),
            jops.KernelParams(*tiles))


def _close(a, b, rtol=RTOL, scale=None):
    """|a - b| <= rtol * scale, scale defaulting to max |b|. True squared
    distances (min partial distance + ||x||^2) cancel terms of size
    ||x||^2, so they pass that as the scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(scale, 1.0))


def _norm_scale(x):
    return float((x.astype(np.float64) ** 2).sum(1).max())


INPUTS = {"blobs": _blob_inputs, "ties": _tie_inputs}


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("data", sorted(INPUTS))
class TestKernelParity:
    def test_fused_assign(self, data, tiles):
        x, c = INPUTS[data]()
        xt, ct, p, jp = _both(x, c, tiles)
        am, md = ops.fused_assign(xt, ct, p)
        jam, jmd = jops.fused_assign(x, c, jp, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        _close(md.numpy(), jmd)

    def test_fused_lloyd(self, data, tiles):
        x, c = INPUTS[data]()
        xt, ct, p, jp = _both(x, c, tiles)
        am, md, sums, counts = ops.fused_lloyd(xt, ct, p)
        jam, jmd, jsums, jcounts = jops.fused_lloyd(x, c, jp, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        _close(md.numpy(), jmd, scale=_norm_scale(x))
        _close(sums.numpy(), jsums)

    def test_fused_assign_ft(self, data, tiles):
        x, c = INPUTS[data]()
        xt, ct, p, jp = _both(x, c, tiles)
        am, md, det = ops.fused_assign_ft(xt, ct, p)
        jam, jmd, jdet = jops.fused_assign_ft(x, c, jp, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        assert int(det) == int(jdet) == 0
        _close(md.numpy(), jmd)

    def test_fused_lloyd_ft(self, data, tiles):
        x, c = INPUTS[data]()
        xt, ct, p, jp = _both(x, c, tiles)
        am, md, sums, counts, det = ops.fused_lloyd_ft(xt, ct, p)
        jam, jmd, jsums, jcounts, jdet = jops.fused_lloyd_ft(
            x, c, jp, interpret=True)
        np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        assert int(det) == int(jdet) == 0
        _close(md.numpy(), jmd, scale=_norm_scale(x))
        _close(sums.numpy(), jsums)


def test_tie_break_is_lowest_index():
    """The planted duplicates resolve to the lower index, as jnp.argmin."""
    x, c = _tie_inputs()
    am, _ = ops.fused_assign(torch.from_numpy(x), torch.from_numpy(c),
                             ops.KernelParams(128, 128, 128))
    am = am.numpy()
    for i, orig in enumerate((10, 127, 30, 5) * 18):
        assert am[7 * i] == orig


# (row, col, f_step, delta): first/last row, the ragged last centroid tile,
# both feature tiles, both signs
FAULTS = [(0, 0, 0, 2.0 ** 20), (516, 259, 1, -2.0 ** 23),
          (300, 130, 1, 2.0 ** 18), (129, 127, 0, -2.0 ** 19)]


@pytest.mark.parametrize("fault", FAULTS)
def test_assign_ft_same_descriptor(fault):
    x, c = _blob_inputs()
    xt, ct, p, jp = _both(x, c, TILES[0])
    row, col, f_step, delta = fault
    inj = ops.plan_injection_tile(M, K, F, p, row, col, f_step, delta)
    jinj = jops.plan_injection_tile(M, K, F, jp, row, col, f_step, delta)
    np.testing.assert_array_equal(inj.numpy(), np.asarray(jinj))
    clean_am, clean_md, _ = ops.fused_assign_ft(xt, ct, p)
    am, md, det = ops.fused_assign_ft(xt, ct, p, inj=inj)
    jam, jmd, jdet = jops.fused_assign_ft(x, c, jp, inj=jinj, interpret=True)
    assert int(det) == int(jdet) == 1
    np.testing.assert_array_equal(am.numpy(), clean_am.numpy())
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    _close(md.numpy(), clean_md.numpy())
    _close(md.numpy(), jmd)


@pytest.mark.parametrize("slots", [
    {"distance": (2, 1, 0, 17, 100, 2.0 ** 21)},
    {"update": (3, 8, 150, -2.0 ** 20)},
    {"distance": (4, 2, 1, 4, 3, -2.0 ** 18), "update": (0, 0, 0, 2.0 ** 22)},
])
def test_lloyd_ft_same_descriptor(slots):
    """Equal detection counts in both packages; the port's corrected step
    is bit for bit its clean step (assignment, sums, counts)."""
    x, c = _blob_inputs()
    xt, ct, p, jp = _both(x, c, TILES[0])
    inj = t_llft.make_injection(**slots)
    jinj = j_llft.make_injection(**slots)
    np.testing.assert_array_equal(inj.numpy(), np.asarray(jinj))
    clean = ops.fused_lloyd_ft(xt, ct, p)
    hit = ops.fused_lloyd_ft(xt, ct, p, inj=inj)
    jhit = jops.fused_lloyd_ft(x, c, jp, inj=jinj, interpret=True)
    assert int(hit[4]) == int(jhit[4]) == len(slots)
    for a, b in zip(hit[:4:2], clean[:4:2]):
        assert torch.equal(a, b)
    assert torch.equal(hit[3], clean[3])
    np.testing.assert_array_equal(hit[0].numpy(), np.asarray(jhit[0]))
    _close(hit[2].numpy(), jhit[2])


def test_data_plan_matches_reference():
    x, _ = _blob_inputs()
    plan = ops.plan_data(torch.from_numpy(x), ops.KernelParams(128, 128, 128))
    jplan = jops.plan_data(jnp.asarray(x), jops.KernelParams(128, 128, 128))
    np.testing.assert_array_equal(plan.xp.numpy(), np.asarray(jplan.xp))
    _close(plan.xn.numpy(), jplan.xn)
    assert (plan.m, plan.f) == (jplan.m, jplan.f)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_tree_sum_matches_reference_bitwise(n):
    a = np.random.default_rng(n).normal(size=(n, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(ops._tree_sum(torch.from_numpy(a)).numpy(),
                                  np.asarray(jops._tree_sum(jnp.asarray(a))))


def test_pad_centroids_inf_norms():
    c = torch.ones(5, 3)
    cp, cn = ops._pad_centroids(c, 5, 128, 32)
    assert cp.shape == (128, 32)
    assert torch.isinf(cn[5:]).all() and torch.equal(cn[:5], torch.full(
        (5,), 3.0))
