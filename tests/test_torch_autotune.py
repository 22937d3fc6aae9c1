"""The port's tile selection (``core/autotune.py``), its table
(``api/cache.py``), the estimators' ``autotune=`` and the registry's public
surface, on the CPU.

* ``shape_bucket``, ``batch_bucket`` and the ladder planner's
  ``_ladder_cost`` equal the reference's functions on a grid of inputs;
* a table entry never crosses a kind, a dtype or a batch bucket; ladder
  entries and files round-trip; a miss is the model's winner, memoised;
* every model winner is feasible and a tile the CUDA kernels are built
  for, and at ``chip_smoke.py``'s shapes the model keeps today's tiles,
  ``ops.clamp_params`` of (128, 128, 32);
* ``measure_score`` refuses the CPU;
* ``list_backends()`` names the reference's backends but the host-only
  ``*_xla`` ones ``convert`` maps, and ``docs/backends_torch.md`` is fresh.
"""
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import cache as j_cache  # noqa: E402
from repro.api import list_backends as j_list_backends  # noqa: E402
from repro.serve import tuning as j_tuning  # noqa: E402
from repro_torch import convert, hw  # noqa: E402
from repro_torch.api import (AutotuneCache, FaultPolicy, KMeans,  # noqa: E402
                             batch_bucket, default_cache, list_backends,
                             shape_bucket)
from repro_torch.api import registry  # noqa: E402
from repro_torch.batch import BatchedKMeans  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import tuning  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

DTYPES = ("float32", "bfloat16", "float16")
TODAY = ops.KernelParams(128, 128, 32)
GRID = (0, 1, 2, 3, 63, 64, 65, 1000, 4096, 65_536, 1 << 20, 3_000_001)


@pytest.mark.parametrize("m,k,f", list(itertools.product(
    GRID[::2], GRID[1::3], (1, 16, 100, 128, 1025))))
def test_shape_bucket_matches_reference(m, k, f):
    assert shape_bucket(m, k, f) == j_cache.shape_bucket(m, k, f)


@pytest.mark.parametrize("b", GRID)
def test_batch_bucket_matches_reference(b):
    assert batch_bucket(b) == j_cache.batch_bucket(b)


@pytest.mark.parametrize("ladder", [(4096,), (64, 4096), (128, 512, 2048),
                                    (64, 256, 1024, 4096)])
def test_ladder_cost_matches_reference(ladder):
    rng = np.random.default_rng(len(ladder))
    cost = {b: float(rng.uniform(1e-5, 1e-3)) for b in ladder}
    sizes = tuple(int(s) for s in rng.integers(1, 3 * ladder[-1], 40))
    assert tuning._ladder_cost(ladder, cost, sizes) == \
        j_tuning._ladder_cost(ladder, cost, sizes)


def test_entries_never_cross_kind_dtype_or_batch():
    cache = AutotuneCache()
    odd = ops.KernelParams(64, 128, 96)           # no model picks it
    cache.put(2048, 1000, 128, odd, kind="assign", dtype="float32")
    cache.put(65_536, 256, 16, odd, kind="batched", dtype="bfloat16",
              batch=48, variant="batched")
    assert cache.lookup(2048, 1000, 128, kind="assign")[1] == odd
    assert cache.lookup(3000, 600, 200, kind="assign")[1] == odd    # bucket
    for kw in (dict(kind="lloyd"), dict(kind="serve"),
               dict(kind="assign", dtype="bfloat16"),
               dict(kind="assign", batch=2)):
        assert cache.lookup(2048, 1000, 128, **kw)[1] != odd, kw
    assert cache.lookup(65_536, 256, 16, kind="batched", dtype="bfloat16",
                        batch=40)[1] == odd          # the same B bucket
    for kw in (dict(batch=8), dict(batch=64), dict(dtype="float32", batch=48)):
        kw = dict(dict(kind="batched", dtype="bfloat16"), **kw)
        assert cache.lookup(65_536, 256, 16, **kw)[1] != odd, kw


def test_miss_is_the_memoised_model_winner():
    cache = AutotuneCache()
    got = cache.lookup(5000, 1000, 128, kind="lloyd_ft", dtype="bfloat16")
    assert got == at.select_params(5000, 1000, 128, kind="lloyd_ft",
                                   dtype="bfloat16")
    assert cache.lookup(5000, 1000, 128, kind="lloyd_ft",
                        dtype=torch.bfloat16) is got
    assert cache._load() == {}                     # nothing was stored


def test_ladder_and_file_round_trip(tmp_path):
    path = tmp_path / "table.json"
    cache = AutotuneCache(str(path))
    cache.put(100_000, 300, 64, ops.KernelParams(64, 128, 32), kind="int8",
              dtype="int8")
    cache.put_ladder(1000, 128, buckets=(128, 2048), window_us=70.5)
    cache.put_ladder(1000, 128, buckets=(64,), window_us=3.0,
                     dtype="bfloat16")
    assert cache.lookup_ladder(1000, 128) == ((128, 2048), 70.5)
    assert cache.lookup_ladder(1000, 128, dtype="bfloat16") == ((64,), 3.0)
    assert cache.lookup_ladder(1000, 64) is None
    cache.save()
    raw = json.loads(path.read_text())
    assert raw["schema"] == j_cache.SCHEMA_VERSION == 7
    assert raw["kinds"]["serve/float32/b0"]["ladder:9-7"] == [70.5, 128, 2048]
    again = AutotuneCache(str(path))
    assert again.lookup_ladder(1000, 128) == ((128, 2048), 70.5)
    assert again.lookup(100_000, 300, 64, kind="int8", dtype="int8") == \
        ("generic", ops.KernelParams(64, 128, 32))
    # the reference reads the file: the same schema and entry format
    jc = j_cache.AutotuneCache(str(path))
    assert jc.lookup_ladder(1000, 128) == ((128, 2048), 70.5)
    jp = jc.lookup(100_000, 300, 64, kind="int8", dtype="int8")[1]
    assert (jp.block_m, jp.block_k, jp.block_f) == (64, 128, 32)


def test_old_schema_refused(tmp_path):
    path = tmp_path / "v3.json"
    path.write_text(json.dumps({"schema": 3, "kinds": {}}))
    with pytest.raises(ValueError, match="schema"):
        AutotuneCache(str(path)).lookup(10, 10, 10)


def test_build_persists(tmp_path):
    path = tmp_path / "built.json"
    table = AutotuneCache(str(path)).build(
        [(2048, 1000, 128), (1 << 20, 1000, 128)], kinds=("assign", "serve"))
    assert table["assign/float32/b0"]["20-9-7"] == ["generic", 128, 128, 32]
    assert table["serve/float32/b0"]["11-9-7"][0] == "generic"
    assert json.loads(path.read_text())["kinds"] == table
    with pytest.warns(DeprecationWarning):
        at.build_table([(4096, 64, 32)], path=str(tmp_path / "b.json"))


def test_default_cache_is_the_ports_own_file():
    cache = default_cache()
    assert cache is default_cache()
    assert Path(cache.path) == ROOT / "src" / "repro_torch" / "core" / \
        "autotune_table.json"


SHAPES = [(m, k, f) for m in (1, 100, 128, 2048, 5000, 65_536, 1 << 20)
          for k, f in ((8, 24), (1000, 128), (256, 16), (100, 300))]


@pytest.mark.parametrize("kind", at.KINDS)
def test_every_model_winner_is_feasible_and_built(kind):
    dtypes = ("int8",) if kind == "int8" else DTYPES
    for dt, (m, k, f) in itertools.product(dtypes, SHAPES):
        variant, p = at.select_params(m, k, f, kind=kind, dtype=dt,
                                      batch=48 if kind == "batched" else 1)
        assert at.feasible(p, dt, kind=kind, shape=(m, k, f))
        if kind == "init":
            assert p.block_m == hw.INIT_BLOCK_N
            continue
        assert variant == ("batched" if kind == "batched" else "generic")
        ops.check_cuda_params(ops.clamp_params(m, k, f, p))


def _smoke_shapes():
    """(kind, dtype, m, k, f, batch) of every estimator tile lookup at
    chip_smoke.py's shapes: phases 3-4 / 9 / 10 / 13 (fits at M = 2^20,
    their predicts in 65,536-row chunks), 7 / 14 (the PQ stack and its 48
    single fits) and 12 (the KV codebook)."""
    full = (chip_smoke.M_FULL, chip_smoke.K_FULL, chip_smoke.F_FULL)
    chunk = (65_536, chip_smoke.K_FULL, chip_smoke.F_FULL)
    pq = (chip_smoke.N_PQ, chip_smoke.K_PQ, chip_smoke.F_PQ)
    kv = (chip_smoke.LM_BATCH * chip_smoke.LM_PROMPT * chip_smoke.LM_KV_HEADS
          * 24, chip_smoke.KV_CODEBOOK, chip_smoke.LM_HD)
    out = []
    for dt in DTYPES:
        for kind in ("assign", "lloyd", "lloyd_ft", "pruned"):
            out += [(kind, dt, *full, 1), (kind, dt, *chunk, 1)]
        out += [("batched", dt, *pq, chip_smoke.B_PQ),
                ("lloyd", dt, *pq, 1), ("assign", dt, *pq, 1)]
    out += [("int8", "int8", *full, 1), ("int8", "int8", *chunk, 1)]
    out += [(kind, "float32", *kv, 1) for kind in ("lloyd_ft", "assign")]
    return out


@pytest.mark.parametrize("kind,dtype,m,k,f,batch", _smoke_shapes())
def test_model_keeps_todays_tiles_at_smoke_shapes(kind, dtype, m, k, f,
                                                  batch):
    _, p = AutotuneCache().lookup(m, k, f, kind=kind, dtype=dtype,
                                  batch=batch)
    assert ops.clamp_params(m, k, f, p) == ops.clamp_params(m, k, f, TODAY)


def test_model_prefers_64_rows_under_one_wave():
    """A launch of fewer row tiles than SMs runs a wave whatever its tile:
    the 64-row tile, 1.5x the shared-memory bytes a FMA at f32, still
    halves each block's work."""
    for m in (128 + 64, 2048, 5000):
        assert at.select_params(m, 1000, 128, kind="serve")[1].block_m == 64
    assert at.select_params(64 * 200, 1000, 128)[1].block_m == 128


def test_model_score_terms():
    p = ops.KernelParams(128, 128, 32)
    assign = at.model_score(2048, 1000, 128, p)
    assert at.model_score(2048, 1000, 128, p, kind="serve") == \
        pytest.approx(assign + hw.SERVE_LAUNCH_S)
    assert at.model_score(1 << 20, 1000, 128, p, kind="lloyd_ft") > \
        at.model_score(1 << 20, 1000, 128, p, kind="lloyd")
    assert at.model_score(1 << 20, 1000, 128, p, kind="pruned",
                          prune_rate=0.9) < \
        at.model_score(1 << 20, 1000, 128, p, kind="pruned", prune_rate=0.0)
    one = at.model_score(65_536, 256, 16, p, kind="batched", batch=1)
    assert at.model_score(65_536, 256, 16, p, kind="batched", batch=48) > \
        40 * one
    with pytest.raises(ValueError, match="kind"):
        at.model_score(10, 10, 10, p, kind="nope")


def test_shared_memory_model():
    """The layouts of csrc/fk_kernels.cu: f32 BM 128 73,232 bytes (FT at Fp
    128: 107,280), 2-byte 95,744 (FT 110,608), int8 81,408; an FT f32
    instantiation past the card's 232,448 bytes is infeasible."""
    assert at.tile_smem_bytes(128, 128) == 73_232
    assert at.tile_smem_bytes(128, 128, kind="lloyd_ft") == 107_280
    assert at.tile_smem_bytes(128, 128, dtype="bfloat16") == 95_744
    assert at.tile_smem_bytes(128, 128, kind="lloyd_ft",
                              dtype="float16") == 110_608
    assert at.tile_smem_bytes(128, 128, kind="int8") == 81_408
    assert at.tile_smem_bytes(128, 128, kind="pruned", kp=1024) == \
        73_232 + 4 * (16 + 128 + 8 + 1)
    p = ops.KernelParams(128, 128, 32)
    assert at.feasible(p, kind="lloyd_ft", shape=(1, 1, 4096))
    assert not at.feasible(p, kind="lloyd_ft", shape=(1, 1, 20_000))
    assert not at.feasible(ops.KernelParams(256, 128, 32))
    assert not at.feasible(ops.KernelParams(128, 128, 48))
    with pytest.raises(ValueError, match="no feasible"):
        at.select_params(100, 10, 40_000, kind="lloyd_ft")


def test_parameter_space():
    assert at.parameter_space() == [ops.KernelParams(128, 128, 32),
                                    ops.KernelParams(64, 128, 32)]
    assert at.parameter_space("bfloat16", "init") == [
        ops.KernelParams(hw.INIT_BLOCK_N, 128, 32)]
    assert at.KINDS == ops.PLAN_KINDS == ("assign", "lloyd", "lloyd_ft",
                                          "batched", "pruned", "int8",
                                          "init", "serve")


def test_measure_score_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        at.measure_score(2048, 1000, 128, TODAY, device="cpu")


def test_shard_shape():
    assert at.shard_shape(1024, 10, 3, 4) == (256, 10, 3)
    with pytest.raises(ValueError):
        at.shard_shape(1025, 10, 3, 4)


def test_estimators_take_the_table():
    """``KMeans`` looks up by its backend's kernel kind and its compute
    dtype, ``BatchedKMeans`` by the B bucket too; ``params=`` wins."""
    odd = ops.KernelParams(64, 128, 32)         # the model picks 128 here
    cache = AutotuneCache()
    cache.put(200_000, 40, 24, odd, kind="lloyd_ft", dtype="bfloat16")
    km = KMeans(40, compute_dtype="bfloat16", autotune=cache, device="cpu")
    assert km._resolve_params(200_000, 24) == TODAY    # kind assign: a miss
    ft = KMeans(40, compute_dtype="bfloat16", autotune=cache, device="cpu",
                fault=FaultPolicy.correct())
    assert ft._resolve_params(200_000, 24) == odd
    f32 = KMeans(40, autotune=cache, device="cpu",
                 fault=FaultPolicy.correct())
    assert f32._resolve_params(200_000, 24) == TODAY   # another dtype
    pinned = KMeans(40, compute_dtype="bfloat16", autotune=cache,
                    fault=FaultPolicy.correct(), params=TODAY, device="cpu")
    assert pinned._resolve_params(200_000, 24) == TODAY
    cache.put(100_000, 16, 8, odd, kind="batched", dtype="float32", batch=8,
              variant="batched")
    bk = BatchedKMeans(16, autotune=cache, device="cpu")
    assert bk._resolve_params(8, 100_000, 8) == odd
    assert bk._resolve_params(2, 100_000, 8) == TODAY


def test_fit_with_table_tiles_is_the_explicit_fit():
    """A fit whose tiles come from the table is bit for bit the fit given
    the same tiles explicitly, and ``from_state(autotune=)`` keeps the
    table."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(700, 24)).astype(np.float32)
    c0 = x[:12]
    cache = AutotuneCache()
    cache.put(700, 12, 24, ops.KernelParams(64, 128, 32), kind="lloyd")
    a = KMeans(12, backend="lloyd", max_iter=3, tol=0.0, autotune=cache,
               device="cpu").fit(x, centroids=c0)
    b = KMeans(12, backend="lloyd", max_iter=3, tol=0.0, device="cpu",
               params=ops.KernelParams(64, 128, 32)).fit(x, centroids=c0)
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    again = KMeans.from_state(a.get_state(), device="cpu", autotune=cache)
    assert again.autotune is cache
    bk = BatchedKMeans(4, max_iter=2, tol=0.0, device="cpu").fit(
        x[None, :400])
    assert BatchedKMeans.from_state(bk.get_state(), device="cpu",
                                    autotune=cache).autotune is cache


def test_list_backends_matches_reference():
    mapped = set(convert._REF_BACKENDS) | set(convert._REF_BATCHED_BACKENDS)
    assert all(name.endswith("_xla") for name in mapped)
    assert set(list_backends()) == set(j_list_backends()) - mapped
    assert list_backends() is not registry._REGISTRY


def test_backends_doc_is_fresh(tmp_path, capsys):
    path = ROOT / "docs" / "backends_torch.md"
    assert registry.main(["--check", str(path)]) == registry.EXIT_OK
    assert path.read_text(encoding="utf-8") == registry.render_markdown()
    stale = tmp_path / "stale.md"
    stale.write_text("old\n")
    assert registry.main(["--check", str(stale)]) == registry.EXIT_STALE
    assert registry.main(["--check", str(tmp_path / "none.md")]) == \
        registry.EXIT_STALE
    out = tmp_path / "out.md"
    assert registry.main(["--markdown", str(out)]) == registry.EXIT_OK
    assert out.read_text(encoding="utf-8") == registry.render_markdown()
    assert registry.main(["--nope"]) == registry.EXIT_USAGE
    capsys.readouterr()
