"""Hygiene and core numerics of the PyTorch port, on the CPU.

* no module of ``repro_torch``, and not ``chip_smoke.py``, imports JAX or
  the reference package;
* ``device="cuda"`` without a card raises instead of drifting to the CPU;
* on CPU tensors the kernel wrappers run their plain versions and count no
  launch; on any other device they raise;
* the port's checksum thresholds, campaign draws, blob data, reseeding and
  update numerics equal the reference's on shared inputs.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import checksum as j_checksum  # noqa: E402
from repro.core import fault as j_fault  # noqa: E402
from repro.core import kmeans as j_kmeans  # noqa: E402
from repro.data.blobs import make_blobs as j_make_blobs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.api import (BackendCapabilityError, FaultPolicy,  # noqa: E402
                             InjectionCampaign, KMeans, get_backend)
from repro_torch.core import checksum, fault  # noqa: E402
from repro_torch.core import kmeans as t_kmeans  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import distance_argmin as da  # noqa: E402
from repro_torch.kernels import distance_argmin_ft as daft  # noqa: E402
from repro_torch.kernels import kmeanspp_init as kpp  # noqa: E402
from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import lloyd_step_ft as llft  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import update as up  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
WRAPPERS = (da.distance_argmin, ll.lloyd_step, daft.distance_argmin_ft,
            llft.lloyd_step_ft, ll.tile_update, ll.lloyd_step_batched,
            kpp.kmeanspp_round, daft.encode_centroids, llft.verify_entries,
            up.update_entries, up.tree_reduce)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        assert KMeans(4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            KMeans(4)
        with pytest.raises(RuntimeError):
            KMeans(4, device="cuda:0")


def test_wrappers_count_no_launch_on_cpu():
    x, _ = make_blobs(300, 70, 5, seed=2)
    xt = torch.from_numpy(x)
    c = xt[:150]
    before = [w.launches for w in WRAPPERS]
    p = ops.KernelParams(128, 128, 32)
    ops.fused_assign(xt, c, p)
    ops.fused_lloyd(xt, c, p)
    ops.fused_assign_ft(xt, c, p)
    ops.fused_lloyd_ft(xt, c, p, inj=llft.make_injection(
        update=(0, 1, 2, 2.0 ** 20)))
    ops.fused_lloyd_ft(xt.bfloat16(), c, p)
    am = ops.fused_assign(xt, c, p)[0]
    ops.tiled_update(ops.plan_data(xt, ops.clamp_params(300, 150, 70, p)),
                     am, 150, use_dmr=True)
    stack = xt.view(3, 100, 70)
    ops.fused_lloyd_batched(stack, stack[:, :7], p)
    kpp.init_kmeanspp_fused(stack, 5, [0, 1, 2])
    assert [w.launches for w in WRAPPERS] == before == [0] * len(WRAPPERS)


def test_wrapper_refuses_other_devices():
    """No silent fallback: tensors on a device that is neither the CPU nor
    one CUDA device are refused."""
    x = torch.empty((128, 32), device="meta")
    c = torch.empty((128, 32), device="meta")
    cn = torch.empty((128,), device="meta")
    with pytest.raises(RuntimeError, match="CPU or on one CUDA"):
        da.distance_argmin(x, c, cn, block_m=128, block_k=128, block_f=32)
    with pytest.raises(RuntimeError):
        da.distance_argmin(x.cpu(), c, cn, block_m=128, block_k=128,
                           block_f=32)


def test_wrapper_rejects_unpadded_shapes():
    with pytest.raises(ValueError, match="unpadded"):
        da.distance_argmin(torch.zeros(100, 32), torch.zeros(128, 32),
                           torch.zeros(128), block_m=128, block_k=128,
                           block_f=32)
    with pytest.raises(ValueError, match="unpadded"):
        ll.lloyd_step_batched(torch.zeros(2, 100, 32),
                              torch.zeros(2, 128, 32), torch.zeros(2, 128),
                              100, block_m=128, block_k=128, block_f=32)
    with pytest.raises(ValueError, match="unpadded"):
        kpp.kmeanspp_round(torch.zeros(2, 300, 5), torch.zeros(2, 300),
                           torch.zeros(2, 1, 5), torch.zeros(2, 300),
                           block_n=128)


def test_batched_wrappers_refuse_other_devices():
    x = torch.empty((2, 128, 32), device="meta")
    c = torch.empty((2, 128, 32), device="meta")
    cn = torch.empty((2, 128), device="meta")
    with pytest.raises(RuntimeError, match="CPU or on one CUDA"):
        ll.lloyd_step_batched(x, c, cn, 128, block_m=128, block_k=128,
                              block_f=32)
    with pytest.raises(RuntimeError, match="CPU or on one CUDA"):
        kpp.kmeanspp_round(x, cn, c[:, :1], cn, block_n=128)


@pytest.mark.parametrize("tile", [(256, 128, 32), (128, 256, 32),
                                  (128, 128, 48)])
def test_cuda_tile_check(tile):
    with pytest.raises(ValueError, match="not a tile"):
        ops.check_cuda_params(ops.KernelParams(*tile))


def test_default_tiles_are_buildable():
    ops.check_cuda_params(ops.DEFAULT_PARAMS)
    assert ops.clamp_params(10, 3, 5, ops.DEFAULT_PARAMS) == \
        ops.KernelParams(64, 128, 32)


@pytest.mark.parametrize("kw,err", [
    (dict(init="kmeans++-fused"), ValueError),
    (dict(compute_dtype="float64"), ValueError),
    (dict(init="nope"), ValueError),
])
def test_later_slices_raise(kw, err):
    with pytest.raises(err):
        KMeans(4, device="cpu", **kw)


def test_fused_init_refused_like_reference():
    """The single-problem estimator of neither package has the fused
    seeding; both refuse it with the same error type."""
    from repro.api import KMeans as JKMeans
    errors = []
    for make in (lambda: JKMeans(4, init="kmeans++-fused"),
                 lambda: KMeans(4, init="kmeans++-fused", device="cpu")):
        with pytest.raises(Exception) as info:
            make()
        errors.append(type(info.value))
    assert errors == [ValueError, ValueError]


def test_policy_resolution():
    assert FaultPolicy.off().resolve_backend().name == "fused"
    assert FaultPolicy.correct().resolve_backend().name == "lloyd_ft"
    camp = FaultPolicy.correct(injection=InjectionCampaign(targets="both"))
    assert camp.resolve_backend().name == "lloyd_ft"
    with pytest.raises(BackendCapabilityError):
        FaultPolicy.correct().resolve_backend("fused")
    with pytest.raises(BackendCapabilityError):
        camp.resolve_backend("fused_ft")
    with pytest.raises(ValueError):
        FaultPolicy(mode="off", injection=InjectionCampaign())


@pytest.mark.parametrize("name,kind,intervals", [
    ("fused", "assign", 0), ("fused_ft", "assign", 1), ("lloyd", "lloyd", 0),
    ("lloyd_ft", "lloyd_ft", 2), ("gemm_fused", "assign", 0),
    ("lloyd_batched", "batched", 0)])
def test_registry_flags_match_reference(name, kind, intervals):
    from repro.api import get_backend as j_get_backend
    b, jb = get_backend(name), j_get_backend(name)
    assert (b.kernel_kind, b.protected_intervals) == (kind, intervals)
    assert (b.kernel_kind, b.protected_intervals) == (jb.kernel_kind,
                                                      jb.protected_intervals)
    for flag in ("supports_ft", "takes_params", "takes_injection",
                 "fuses_update", "supports_batch"):
        assert getattr(b, flag) == getattr(jb, flag)


@pytest.mark.parametrize("k", [1, 128, 384, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_threshold_factor_matches_reference(k, dtype):
    assert checksum.threshold_factor(k, dtype) == \
        j_checksum.threshold_factor(k, jnp.dtype(dtype))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind,targets,rate", [
    ("assign", ("distance",), 1.0), ("lloyd_ft", ("distance", "update"), 1.0),
    ("lloyd_ft", ("distance", "update"), 1.7), ("lloyd_ft", ("update",), 0.5)])
def test_campaign_draws_match_reference(seed, kind, targets, rate):
    p = ops.KernelParams(128, 128, 128)
    jp = jops.KernelParams(128, 128, 128)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        a = fault.draw_step_injection(rng, 517, 260, 200, p, rate=rate,
                                      targets=targets, kind=kind)
        b = j_fault.draw_step_injection(jrng, 517, 260, 200, jp, rate=rate,
                                        targets=targets, kind=kind)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_blobs_match_reference():
    x, y = make_blobs(301, 17, 6, seed=4, shard=1, num_shards=7)
    jx, jy = j_make_blobs(301, 17, 6, seed=4, shard=1, num_shards=7)
    np.testing.assert_array_equal(x, np.asarray(jx))
    np.testing.assert_array_equal(y, np.asarray(jy))


def test_reseed_empty_matches_reference():
    """Stable farthest-first donors, ties in the distances included."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    c = rng.normal(size=(6, 4)).astype(np.float32)
    counts = np.array([3, 0, 5, 0, 0, 2], np.float32)
    md = rng.integers(0, 5, size=50).astype(np.float32)     # many ties
    got = t_kmeans.reseed_empty(torch.from_numpy(x), torch.from_numpy(c),
                                torch.from_numpy(counts), torch.from_numpy(md))
    want = j_kmeans.reseed_empty(None, jnp.asarray(x), jnp.asarray(c),
                                 jnp.asarray(counts), jnp.asarray(md))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reseed_empty_is_per_problem():
    """The stacked reseed picks, problem by problem, the single-problem
    donors (the reference vmaps its reseed), ties included."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40, 4)).astype(np.float32)
    c = rng.normal(size=(3, 6, 4)).astype(np.float32)
    counts = rng.integers(0, 3, size=(3, 6)).astype(np.float32)
    md = rng.integers(0, 4, size=(3, 40)).astype(np.float32)
    got = t_kmeans.reseed_empty(*map(torch.from_numpy,
                                             (x, c, counts, md)))
    for b in range(3):
        want = j_kmeans.reseed_empty(None, jnp.asarray(x[b]),
                                     jnp.asarray(c[b]),
                                     jnp.asarray(counts[b]),
                                     jnp.asarray(md[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_means_and_centroid_update_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(90, 6)).astype(np.float32)
    am = rng.integers(0, 7, size=90).astype(np.int32)
    am[am == 3] = 2                                   # an empty cluster
    prev = rng.normal(size=(7, 6)).astype(np.float32)
    for dmr in (False, True):
        c, n = t_kmeans.centroid_update(torch.from_numpy(x),
                                        torch.from_numpy(am), 7,
                                        torch.from_numpy(prev), use_dmr=dmr)
        jc, jn = j_kmeans.centroid_update(jnp.asarray(x), jnp.asarray(am), 7,
                                          jnp.asarray(prev), use_dmr=dmr)
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)
        np.testing.assert_array_equal(c.numpy()[3], prev[3])


def test_distance_matrix_oracle():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(40, 9)).astype(np.float32)
    c = rng.normal(size=(5, 9)).astype(np.float32)
    from repro.kernels import ref as j_ref
    np.testing.assert_allclose(
        ref.distance_matrix(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        np.asarray(j_ref.distance_matrix(jnp.asarray(x), jnp.asarray(c))),
        rtol=1e-5, atol=1e-5)


def test_recompute_update_is_bitwise_and_conditional():
    """The plain recompute of one tile reproduces the one-pass step's dense
    partials (its plain specification) exactly, and leaves them alone when
    nothing mismatched."""
    x, _ = make_blobs(300, 64, 5, seed=6)
    plan = ops.plan_data(torch.from_numpy(x), ops.KernelParams(64, 128, 32))
    cp, cn = ops._pad_centroids(plan.x[:9], 9, 128, plan.xp.shape[1])
    _, am, sums, counts = ll.lloyd_step_plain(plan.xp, cp, cn, plan.m, 64)
    ref_sums, ref_counts = sums.clone(), counts.clone()
    sums[4] = 7.0
    counts[4] = 7.0
    tile = torch.tensor(4, dtype=torch.int32)
    ll.tile_update(plan.xp, am, sums, counts, true_m=plan.m, block_m=64,
                   tile=tile, gate=torch.tensor(0, dtype=torch.int32))
    assert float(sums[4].max()) == 7.0
    ll.tile_update(plan.xp, am, sums, counts, true_m=plan.m, block_m=64,
                   tile=tile, gate=torch.tensor(1, dtype=torch.int32))
    assert torch.equal(sums, ref_sums) and torch.equal(counts, ref_counts)


@pytest.mark.parametrize("gate", [None, 0, 1])
def test_tile_update_all_tiles(gate):
    """Over every row tile the update reproduces the one-pass step's dense
    partials (its plain specification) bit for bit; a closed gate leaves
    the buffers alone."""
    x, _ = make_blobs(300, 64, 5, seed=8)
    plan = ops.plan_data(torch.from_numpy(x), ops.KernelParams(64, 128, 32))
    cp, cn = ops._pad_centroids(plan.x[:9], 9, 128, plan.xp.shape[1])
    _, am, want_s, want_c = ll.lloyd_step_plain(plan.xp, cp, cn, plan.m, 64)
    sums = torch.full_like(want_s, 7.0)
    counts = torch.full_like(want_c, 7.0)
    ll.tile_update(plan.xp, am, sums, counts, true_m=plan.m, block_m=64,
                   gate=None if gate is None else torch.tensor(
                       gate, dtype=torch.int32))
    if gate == 0:
        assert bool((sums == 7.0).all()) and bool((counts == 7.0).all())
    else:
        assert torch.equal(sums, want_s) and torch.equal(counts, want_c)


@pytest.mark.parametrize("use_dmr", [False, True])
@pytest.mark.parametrize("block_m", [64, 128])
def test_tiled_update_is_one_pass_order(use_dmr, block_m):
    """The two-pass update of a padded plan sums bit for bit as the one-pass
    kernel, with or without DMR, and agrees with the plain reduction."""
    x, _ = make_blobs(433, 70, 9, seed=9)
    p = ops.KernelParams(block_m, 128, 32)
    xt = torch.from_numpy(x)
    c = xt[:140]
    am, _, want_s, want_c = ops.fused_lloyd(xt, c, p)
    sums, counts = ops.tiled_update(ops.plan_data(xt, p), am, 140,
                                    use_dmr=use_dmr)
    assert torch.equal(sums, want_s) and torch.equal(counts, want_c)
    plain_s, plain_c = ref.centroid_update(xt, am, 140)
    assert torch.equal(counts, plain_c)
    torch.testing.assert_close(sums, plain_s, rtol=1e-5, atol=1e-4)


def test_dmr_mismatch_flags():
    from repro_torch.core import dmr
    a = (torch.ones(3), torch.arange(3))
    assert not bool(dmr.mismatch(a, (torch.ones(3), torch.arange(3))))
    assert bool(dmr.mismatch(a, (torch.tensor([1.0, 2.0, 1.0]),
                                 torch.arange(3))))
    assert bool(dmr.mismatch(a, (torch.ones(3), torch.tensor([0, 1, 5]))))
    assert not bool(dmr.mismatch(a, (torch.ones(3) + 1e-3, torch.arange(3)),
                                 atol=1e-2))


@pytest.mark.parametrize("fault", [None, ((17, 3), 2.0 ** 20),
                                   ((39, 0), -2.0 ** 22)])
def test_oracles_match_reference(fault):
    from repro.kernels import ref as j_ref
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 9)).astype(np.float32)
    c = rng.normal(size=(5, 9)).astype(np.float32)
    xt, ct, xj, cj = torch.from_numpy(x), torch.from_numpy(c), \
        jnp.asarray(x), jnp.asarray(c)
    md, am = ref.distance_argmin(xt, ct)
    jmd, jam = j_ref.distance_argmin(xj, cj)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_allclose(md.numpy(), np.asarray(jmd), rtol=1e-5)
    out = ref.lloyd_step(xt, ct)
    jout = j_ref.lloyd_step(xj, cj)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]),
                               rtol=1e-5, atol=1e-5)
    pos, delta = fault if fault else (None, None)
    md, am, det = ref.distance_argmin_ft(xt, ct, delta, pos)
    jmd, jam, jdet = j_ref.distance_argmin_ft(
        xj, cj, None if delta is None else jnp.float32(delta), pos)
    assert int(det) == int(jdet) == (fault is not None)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    np.testing.assert_allclose(md.numpy(), np.asarray(jmd), rtol=1e-4,
                               atol=1e-4)
