"""DMR in the port, on the CPU: the DMR centroid-update kernel's plain
version (``kernels.centroid_update_dmr``) against the reference's Pallas
kernel in interpret mode, its mismatch flag, and the two-pass update of a
backend without tiles (``gemm_fused``, ``abft_offline``), which runs two
updates per clean step and recomputes, gated on the device, only on a
mismatch.

Tolerance of the sums: both replicas and both packages add the same f32
values in other orders, so they agree to f32 rounding of the sums
(rtol 1e-5); counts are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.centroid_update_dmr import \
    centroid_update_dmr as j_dmr  # noqa: E402
from repro_torch.api import FaultPolicy, KMeans  # noqa: E402
from repro_torch.core import kmeans as km_mod  # noqa: E402
from repro_torch.data.blobs import make_blobs  # noqa: E402
from repro_torch.kernels import centroid_update_dmr as cud  # noqa: E402
from repro_torch.kernels import lloyd_step as ll  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _inputs(m, f, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, f)).astype(np.float32),
            rng.integers(0, k, size=m).astype(np.int32))


# tests/test_kernels_extra.py:13-20's shapes
@pytest.mark.parametrize("m,f,k", [(2048, 128, 16), (1024, 256, 8)])
@pytest.mark.parametrize("block_m", [1024, 256, 96])
def test_dmr_update_matches_reference(m, f, k, block_m):
    x, a = _inputs(m, f, k, 0)
    sums, counts, bad = cud.centroid_update_dmr(
        torch.from_numpy(x), torch.from_numpy(a), k, block_m=block_m)
    js, jc, jbad = j_dmr(jnp.asarray(x), jnp.asarray(a), k, interpret=True)
    rs, rc = j_ref.centroid_update(jnp.asarray(x), jnp.asarray(a), k)
    assert int(bad) == int(jbad) == 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(sums.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-4)
    assert sums.shape == (k, f) and counts.dtype == torch.float32
    assert bad.dtype == torch.int32 and bad.shape == ()


def test_dmr_padded_rows_ignored():
    """tests/test_kernels_extra.py's padded case: rows with assign = -1 (and
    any assignment outside [0, k)) count nowhere."""
    x, a = _inputs(1024, 64, 8, 2)
    rs, rc = j_ref.centroid_update(jnp.asarray(x), jnp.asarray(a), 8)
    xp = np.concatenate([x, np.full((1024, 64), 7.0, np.float32)])
    ap = np.concatenate([a, np.full(1024, -1, np.int32)])
    ap[-3:] = 8                                  # beyond k: no cluster
    sums, counts, bad = cud.centroid_update_dmr(
        torch.from_numpy(xp), torch.from_numpy(ap), 8, block_m=512)
    js, jc, _ = j_dmr(jnp.asarray(xp), jnp.asarray(np.where(ap == 8, -1, ap)),
                      8, interpret=True)
    assert int(bad) == 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("fault,bad", [((0, 3, 5, 1.0), 1),
                                       ((1, 0, 127, -64.0), 1),
                                       ((1, 7, 0, 1e-6), 0)])
def test_dmr_shadow_fault_flags(fault, bad):
    """The debug perturbation of one shadow partial: flagged when it
    exceeds 1e-4 * max(max|sums|, 1), the reference's comparison; the
    primary sums stay clean."""
    x, a = _inputs(2048, 128, 16, 4)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    clean, counts, _ = cud.centroid_update_dmr(xt, at, 16, block_m=1024)
    sums, counts2, flag = cud.centroid_update_dmr(xt, at, 16, block_m=1024,
                                                  shadow_fault=fault)
    assert int(flag) == bad
    assert torch.equal(sums, clean) and torch.equal(counts, counts2)


# --- the two-pass update of a backend without tiles --------------------------

def _count_updates(monkeypatch, corrupt_first=False):
    """Wrap ``tile_update``: record every call's gate (None = ungated) and
    whether it wrote; optionally corrupt the first (primary) update."""
    calls = []
    real = ll.tile_update

    def wrapped(xp, am, sums_p, counts_p, **kw):
        gate = kw.get("gate")
        real(xp, am, sums_p, counts_p, **kw)
        wrote = gate is None or int(gate) > 0
        if corrupt_first and not calls:
            sums_p[0, 0, 0] += 1.0
        calls.append((gate is None, wrote))
    monkeypatch.setattr(ll, "tile_update", wrapped)
    return calls


@pytest.mark.parametrize("policy,backend", [
    (FaultPolicy.detect(), None),
    (FaultPolicy(mode="off", update_dmr=True), "gemm_fused")])
def test_clean_raw_step_runs_two_updates(monkeypatch, policy, backend):
    """A clean DMR step of a raw backend: two updates that write, one gated
    recompute that does not; no third update."""
    x, _ = make_blobs(700, 12, 5, seed=3)
    km = KMeans(5, fault=policy, backend=backend, max_iter=1, device="cpu")
    calls = _count_updates(monkeypatch)
    km.fit(x, centroids=x[:5])
    assert km._use_dmr
    assert [c for c in calls if c[1]] == [(True, True), (True, True)]
    assert calls[2:] == [(False, False)]


def test_forced_mismatch_takes_the_recompute(monkeypatch):
    """A corrupted primary update: the replica disagrees, the gated
    recompute runs (three updates that write) and its result is the one
    taken, equal to a clean update's."""
    x, _ = make_blobs(900, 10, 4, seed=7)
    xt = torch.from_numpy(x)
    am = torch.from_numpy(np.random.default_rng(0).integers(
        0, 4, 900).astype(np.int32))
    want_s, want_c = km_mod.protected_sums(xt, am, 4, use_dmr=False)
    calls = _count_updates(monkeypatch, corrupt_first=True)
    sums, counts = km_mod.protected_sums(xt, am, 4, use_dmr=True)
    assert [c for c in calls if c[1]] == [(True, True)] * 2 + [(False, True)]
    assert torch.equal(sums, want_s) and torch.equal(counts, want_c)
    monkeypatch.undo()
    calls = _count_updates(monkeypatch, corrupt_first=True)
    bad_s, _ = km_mod.protected_sums(xt, am, 4, use_dmr=False)
    assert not torch.equal(bad_s, want_s)      # without DMR it stays


def test_raw_update_sums_as_fused_does():
    """The raw backends' update runs at the fused backend's tiles (the
    autotune table's assign winner at the shape), so given the same labels
    it sums bit for bit as a fused fit's update; raw X handed to
    ``protected_sums`` alone is planned at the default tiles."""
    x, _ = make_blobs(1500, 20, 7, seed=5)
    xt = torch.from_numpy(x)
    am = torch.from_numpy(np.random.default_rng(1).integers(
        0, 7, 1500).astype(np.int32))
    p = ops.clamp_params(1500, 7, 20, ops.DEFAULT_PARAMS)
    want = ops.tiled_update(ops.plan_data(xt, p), am, 7, use_dmr=True)
    for dmr in (False, True):
        got = km_mod.protected_sums(xt, am, 7, use_dmr=dmr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    km = KMeans(7, fault=FaultPolicy.detect(), device="cpu")
    p_fused = KMeans(7, device="cpu")._resolve_params(1500, 20)
    plan = km._plan(xt, None)
    assert isinstance(plan, ops.DataPlan) and plan.params == p_fused
    want = ops.tiled_update(ops.plan_data(xt, p_fused), am, 7, use_dmr=True)
    got = km_mod.protected_sums(plan, am, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
