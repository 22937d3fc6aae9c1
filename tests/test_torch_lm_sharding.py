"""The port's LM-side sharding (``repro_torch.dist.sharding``'s LM half,
``launch/mesh.py``, attention's context-parallel branch, the sharded train
step, checkpoints and the launcher on a mesh) against the reference and
against the port's own single-device step, on the CPU.

Placements: for every arch at full size (the port's ``LM(cfg,
device="meta")`` beside the reference's ``abstract_params``) and five
meshes, through a mesh with only ``axis_names`` and ``shape``, the port's
placements equal the reference's ``_spec_for`` leaf for leaf (a stacked
leaf's leading "layers" dim dropped), and the logical axes (``fsdp_hint``
included) are the reference's, at full size and at SMOKE.

Steps: one group of 4 gloo ranks on a ``(data 2, model 2)`` mesh and one of
2 (``make_local_mesh()``: data 2), each spawned once for the module
(``tests/_lm_dist_ranks.py``). internlm2's SMOKE model from the reference's
``PRNGKey(0)`` weights, in f32, against the port's single-device step on
the same weights and batch: loss and grad norm within ``STEP_RTOL``, every
leaf's gradient within ``GRAD_RTOL`` of its norm, the parameters after one
AdamW step within ``PARAM_ATOL`` = lr / 20 (``tests/test_torch_train_step.
py``'s bar), at one and two micro-batches; the bf16 step against the
reference's single-device ``build_train_step`` under that file's bf16 bar
(``BF16_RTOL`` on loss and grad norm) and, for the parameters,
``BF16_MOVED``. ``attend``'s branch on
``model`` 4 against ``_attend_local``: the output and dq / dk / dv, and the
control that takes k's and v's gradients out unsummed, which must break
the bar. The backward run on another thread (as the card's autograd runs
it) must see the forward's mesh in the checkpoint recompute.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import _lm_dist_ranks as R  # noqa: E402
import _lm_parity as P  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.dist import sharding as j_shd  # noqa: E402
from repro.launch.mesh import make_local_mesh as j_local_mesh  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train.steps import build_train_step as j_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.sharding import run_ranks  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import build_train_step, init_opt_state  # noqa: E402
from repro_torch.train.steps import abstract_train_state  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

SPAWN_S = 240               # each group's time limit
STEP_RTOL = 1e-5            # loss, grad norm: f32 sums in another order
GRAD_RTOL = 1e-4            # x the leaf's gradient norm
PARAM_ATOL = R.LR / 20      # tests/test_torch_train_step.py's bar
BF16_RTOL = 2e-2            # tests/test_torch_train_step.py's bf16 bar
# bf16 parameters after one AdamW step: a gradient within bf16 rounding of
# zero may flip its sign (a move of 2 lr, plus one bf16 rounding of the
# leaf's largest); at most this share of a leaf's elements may move by more
# than lr / 20 (measured: 0.59 % for the port's own single-device bf16 step
# against the reference's, and for the mesh's against the single device's)
BF16_MOVED = 0.01
M_RTOL = 2e-5               # tests/test_torch_train_step.py's bar for m
ATTEND_RTOL = 1e-5          # x max|want|, f32
MESHES = [(("data", "model"), (4, 1)), (("data", "model"), (2, 2)),
          (("data", "model"), (1, 4)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
LAUNCH = ["--smoke", "--device", "cpu", "--backend", "gloo", "--batch", "4",
          "--seq", "16", "--steps", "3", "--lr", "1e-3"]


class _Mesh:
    """Only what both packages' ``_spec_for`` read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


# ---------------------------------------------------------------------------
# (i) placements and axes for every arch
# ---------------------------------------------------------------------------

def _reference_leaves(cfg, params, axes) -> dict:
    """{port state-dict name: (shape, axes, stacked)} of the reference's
    trees: period slot j at index t is layer t * period + j, the tail
    follows, the encoder's stack is ``encoder.{i}``."""
    out: dict = {}

    def walk(p, a, prefix, stacked):
        for k in p:
            if isinstance(p[k], dict):
                walk(p[k], a[k], f"{prefix}{k}.", stacked)
            else:
                out[prefix + k] = (tuple(p[k].shape), tuple(a[k]), stacked)

    walk(params["embed"], axes["embed"], "embed.", False)
    walk(params["final_norm"], axes["final_norm"], "final_norm.", False)
    period = len(cfg.layer_pattern)
    n_periods = cfg.num_layers // period if cfg.scan_layers else 0
    for i in range(n_periods * period):
        t, j = divmod(i, period)
        walk(params["periods"][j], axes["periods"][j], f"layers.{i}.", True)
    for i, (p, a) in enumerate(zip(params.get("tail", []),
                                   axes.get("tail", []))):
        walk(p, a, f"layers.{n_periods * period + i}.", False)
    for i in range(cfg.encoder_layers if cfg.encoder_decoder else 0):
        walk(params["encoder"], axes["encoder"], f"encoder.{i}.", True)
    return out


def _as_placements(mesh, spec) -> tuple:
    out = []
    for a in mesh.axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_and_axes_match_reference(arch):
    jcfg = j_get_config(arch)
    sds, jaxes = JLM(jcfg).abstract_params()
    ref = _reference_leaves(jcfg, sds, jaxes)
    lm = LM(get_config(arch), device="meta")
    axes = lm.param_axes()
    shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    assert set(shapes) == set(ref)
    for name, (shape, ax, stacked) in ref.items():
        assert shapes[name] == (shape[1:] if stacked else shape), name
        assert axes[name] == (ax[1:] if stacked else ax), name
        if stacked:
            assert ax[0] == "layers", name
    for names, sizes in MESHES:
        mesh = _Mesh(names, sizes)
        for name, (shape, ax, stacked) in ref.items():
            spec = tuple(j_shd._spec_for(mesh, shape, ax))
            want = _as_placements(mesh, spec[1:] if stacked else spec)
            got = shd._spec_for(mesh, shapes[name], axes[name])
            assert got == want, (arch, sizes, name, got, want)


def test_smoke_axes_match_reference():
    for arch in ARCH_IDS:
        jcfg = j_get_config(arch, smoke=True)
        sds, jaxes = JLM(jcfg).abstract_params()
        axes = LM(get_config(arch, smoke=True), device="meta").param_axes()
        for name, (shape, ax, stacked) in _reference_leaves(
                jcfg, sds, jaxes).items():
            assert axes[name] == (ax[1:] if stacked else ax), (arch, name)


@pytest.mark.parametrize("shape,axes", [
    ((2048, 16, 128), ("embed", "heads", "head_dim")),
    ((1024, 1023), ("embed", "mlp")),
    ((1024, 1024), ("embed", "mlp")),
    ((64, 1024, 2048), ("experts", "embed", "expert_mlp")),
    ((16, 1 << 16), ("vocab", "embed")),
    ((1 << 21,), (None,)),
    ((4, 1 << 19), ("conv", None))])
def test_fsdp_hint_matches_reference(shape, axes):
    assert shd.fsdp_hint(shape, axes) == j_shd.fsdp_hint(shape, axes)


def test_abstract_train_state_places_moments_like_params():
    mesh = _Mesh(("data", "model"), (16, 16))
    tcfg = R.train_config(1)
    lm, params, opt, axes = abstract_train_state(
        get_config("internlm2-1.8b"), mesh, tcfg)
    assert set(params) == set(axes) == set(opt["m"]) == set(opt["v"])
    for name, a in params.items():
        assert opt["m"][name].placements == opt["v"][name].placements \
            == a.placements
        assert opt["m"][name].dtype == torch.float32
    assert params["embed.embedding"].placements == (Shard(1), Shard(0))
    assert opt["step"].placements == (Replicate(), Replicate())


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert shd.active_mesh() is None
    assert shd.constrain(x, ("batch", "seq_tp", None)) is x


def test_dtensor_keeps_its_implicit_replication_switch():
    # plain_as_replicated writes DTensor's private switch; a torch without
    # it must fail here, not silently on a mesh
    from torch.distributed.tensor import DTensor
    dispatch = DTensor._op_dispatcher
    assert hasattr(dispatch, "_allow_implicit_replication")
    before = dispatch._allow_implicit_replication
    with shd.plain_as_replicated():
        assert dispatch._allow_implicit_replication is True
        with shd.plain_as_replicated():
            pass
        assert dispatch._allow_implicit_replication is True
    assert dispatch._allow_implicit_replication == before


@pytest.mark.parametrize("backend,route", [
    ("gloo", "host"), ("nccl", "as_is"), ("cpu:gloo,cuda:nccl", "as_is")])
def test_gathers_go_through_host_only_on_gloo(monkeypatch, backend, route):
    monkeypatch.setattr(shd, "_group_backend", lambda name: backend)
    monkeypatch.setattr(shd, "_gather_on_host", lambda *a: "host")
    monkeypatch.setattr(shd, "_gather_as_is", lambda *a: "as_is")
    assert shd._staged_gather(torch.ones(2), 2, "g") == route


def test_shard_params_takes_a_module_or_meta_tensors():
    with pytest.raises(TypeError, match="takes meta tensors"):
        shd.shard_params(_Mesh(("data", "model"), (2, 2)),
                         {"w": torch.ones(4, 4)}, {"w": ("embed", "mlp")})


def test_meshes_need_their_ranks():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    with pytest.raises(ValueError, match="256 ranks, the world has 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks, the world has 1"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        make_local_mesh(2, device="cpu")


# ---------------------------------------------------------------------------
# The rank groups
# ---------------------------------------------------------------------------

def _reference_weights(dtype: str):
    """(reference config, its params, the port's state dict of them)."""
    jcfg = dataclasses.replace(j_get_config(R.ARCH, smoke=True), dtype=dtype,
                               param_dtype=dtype)
    params, _ = JLM(jcfg).init(jax.random.PRNGKey(0))
    cfg = R.smoke_config(dtype)
    return jcfg, params, convert.lm_params_from_reference(
        P.numpy_tree(params), cfg)


@pytest.fixture(scope="module")
def weights():
    return {dt: _reference_weights(dt) for dt in ("float32", "bfloat16")}


@pytest.fixture(scope="module")
def four(weights):
    sds = {dt: w[2] for dt, w in weights.items()}
    return run_ranks(R.four_ranks, 4, device="cpu", backend="gloo",
                     timeout=SPAWN_S, args=(sds,))


@pytest.fixture(scope="module")
def single_ckpt():
    tmp = tempfile.mkdtemp(prefix="repro_lm_ckpt_")
    single = os.path.join(tmp, "single")
    records = launch.main(LAUNCH + ["--ckpt-every", "3", "--ckpt-dir",
                                    single])
    return tmp, single, records


@pytest.fixture(scope="module")
def two(single_ckpt):
    tmp, single, _ = single_ckpt
    return run_ranks(R.two_ranks, 2, device="cpu", backend="gloo",
                     timeout=SPAWN_S,
                     args=(LAUNCH, os.path.join(tmp, "mesh"), single))


def _single_step(sd, accum, dtype="float32"):
    cfg = R.smoke_config(dtype)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(sd)
    tcfg = R.train_config(accum)
    opt = init_opt_state(dict(lm.named_parameters()), tcfg)
    shape = ShapeConfig("t", seq_len=R.SEQ, global_batch=R.ROWS,
                        kind="train")
    m = build_train_step(cfg, shape, tcfg, device="cpu")(
        lm, opt, R._torch(R.batch(cfg)))
    return m, opt, {n: p.detach().float().numpy()
                    for n, p in lm.named_parameters()}


def _single_grads(sd):
    cfg = R.smoke_config()
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(sd)
    lm.requires_grad_(True)
    loss, _ = lm.loss(R._torch(R.batch(cfg)))
    loss.backward()
    return {n: p.grad.numpy() for n, p in lm.named_parameters()}


def _grad_errors(got: dict, want: dict) -> dict:
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.linalg.norm(w)), 1e-30) for n, w in want.items()}


# ---------------------------------------------------------------------------
# (ii) the f32 step on (data 2, model 2)
# ---------------------------------------------------------------------------

def test_ranks_agree(four):
    for r in four[1:]:
        for key in ("float32/1", "float32/2", "bfloat16/1"):
            assert r[key]["loss"] == four[0][key]["loss"]
            for n, p in r[key]["params"].items():
                np.testing.assert_array_equal(p, four[0][key]["params"][n])


def test_placements_on_the_mesh(four):
    r = four[0]
    assert r["placements"]["layers.0.mix.wq"] == str(
        (Replicate(), Shard(1)))
    assert r["placements"]["embed.embedding"] == str(
        (Replicate(), Shard(0)))
    assert r["m_placements"] == r["placements"]
    # the forced ZeRO-3 layout shards the embed dim over data too
    assert r["fsdp_placements"]["layers.0.mix.wq"] == str(
        (Shard(0), Shard(1)))


@pytest.mark.parametrize("what", ["grads", "grads_thread", "grads_fsdp"])
def test_gradients_match_single_device(four, weights, what):
    errs = _grad_errors(four[0][what], _single_grads(weights["float32"][2]))
    assert max(errs.values()) <= GRAD_RTOL, errs


@pytest.mark.parametrize("key", ["float32/1", "float32/2"])
def test_step_matches_single_device(four, weights, key):
    m, _, want = _single_step(weights["float32"][2], int(key[-1]))
    got = four[0][key]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=STEP_RTOL)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                             rel=STEP_RTOL)
    for n, w in want.items():
        assert float(np.abs(got["params"][n] - w).max()) <= PARAM_ATOL, n


def test_zero3_step_matches_single_device(four, weights):
    """Every weight with an embed dim sharded over data too (``fsdp_hint``'s
    threshold lowered to 0): the loss, the grad norm and the first moment
    (the clipped gradient x (1 - b1)) within ``M_RTOL`` of each leaf's
    largest. The parameters are held by the step test above: AdamW's first
    step divides a gradient by its own magnitude, so one within ``eps`` of
    zero moves its parameter by a visible share of lr on any rounding."""
    m, opt, _ = _single_step(weights["float32"][2], 1)
    got = four[0]["fsdp/1"]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=STEP_RTOL)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                             rel=STEP_RTOL)
    for n, w in opt["m"].items():
        w = w.numpy()
        bar = M_RTOL * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got["m"][n] - w).max()) <= bar, n


def test_unsummed_kv_gradients_break_the_bar(four, weights):
    errs = _grad_errors(four[0]["grads_unsummed"],
                        _single_grads(weights["float32"][2]))
    bad = {n for n, e in errs.items() if e > GRAD_RTOL}
    assert {f"layers.{i}.mix.{w}" for i in (0, 1)
            for w in ("wk", "wv")} <= bad, errs


# ---------------------------------------------------------------------------
# (iii) the bf16 step against the reference's single-device step
# ---------------------------------------------------------------------------

def test_bf16_step_matches_reference(four, weights):
    jcfg, params, _ = weights["bfloat16"]
    tcfg = R.train_config(1)
    jt = j_opt.TrainConfig(**dataclasses.asdict(tcfg))
    jb = j_build(jcfg, j_local_mesh(),
                 JShape("t", seq_len=R.SEQ, global_batch=R.ROWS,
                        kind="train"), jt)
    new, _, jm = jb.step_fn(params, j_opt.init_opt_state(params, jt),
                            P.as_jax(R.batch(jcfg)))
    want = convert.lm_params_from_reference(P.numpy_tree(new),
                                            R.smoke_config("bfloat16"))
    got = four[0]["bfloat16/1"]
    assert got["loss"] == pytest.approx(float(jm["loss"]), rel=BF16_RTOL)
    assert got["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                             rel=BF16_RTOL)
    for n, w in want.items():
        w = w.float().numpy()
        diff = np.abs(got["params"][n] - w)
        bar = 2 * R.LR + 2.0 ** -8 * float(np.abs(w).max())
        assert float(diff.max()) <= bar, n
        assert float((diff > PARAM_ATOL).mean()) <= BF16_MOVED, n


# ---------------------------------------------------------------------------
# (iv) attend's context-parallel branch on model 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(R.ATTEND))
def test_attend_branch_matches_local(four, case):
    got = four[0]["attend"][case]
    want = R.attend_plain(case)
    for key in ("out", "dq", "dk", "dv"):
        bar = ATTEND_RTOL * float(np.abs(want[key]).max())
        assert float(np.abs(got[key] - want[key]).max()) <= bar, key


def test_attend_without_partial_breaks_the_bar(four):
    got = four[0]["attend"]["unsummed"]
    want = R.attend_plain("causal")
    for key in ("out", "dq"):
        bar = ATTEND_RTOL * float(np.abs(want[key]).max())
        assert float(np.abs(got[key] - want[key]).max()) <= bar, key
    for key in ("dk", "dv"):
        bar = ATTEND_RTOL * float(np.abs(want[key]).max())
        assert float(np.abs(got[key] - want[key]).max()) > bar, key


# ---------------------------------------------------------------------------
# Checkpoints and the launcher on 2 ranks
# ---------------------------------------------------------------------------

def test_launcher_on_two_ranks_matches_single_device(two, single_ckpt):
    _, _, single = single_ckpt
    for r in two:
        assert [x["loss"] for x in r["records"]] == pytest.approx(
            [x["loss"] for x in single], rel=STEP_RTOL)
        assert [x["grad_norm"] for x in r["records"]] == pytest.approx(
            [x["grad_norm"] for x in single], rel=STEP_RTOL)
        assert len(r["records"]) == 3
        assert not any(x["straggler"] for x in r["records"])


def test_mesh_snapshot_restores_on_one_device(two, single_ckpt):
    tmp, _, _ = single_ckpt
    run = launch.setup(launch.parse(LAUNCH + ["--ckpt-dir",
                                              os.path.join(tmp, "mesh")]))
    from repro_torch.ft import Checkpointer
    st = Checkpointer(os.path.join(tmp, "mesh")).restore()
    assert st["_step"] == 3
    launch.load_state(run["lm"], run["opt"], st)
    for n, p in run["lm"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      two[0]["mesh_restored"][n])
        np.testing.assert_array_equal(p.detach().numpy(),
                                      st[f"params/{n}"])


def test_single_snapshot_restores_on_the_mesh(two, single_ckpt):
    _, single, _ = single_ckpt
    from repro_torch.ft import Checkpointer
    st = Checkpointer(single).restore()
    for r in two:
        for n, p in r["restored"].items():
            np.testing.assert_array_equal(p, st[f"params/{n}"])
        np.testing.assert_array_equal(r["restored_m"],
                                      st["opt/m/layers.0.mix.wq"])


def test_gathers_on_a_gloo_group(two):
    want = np.concatenate([np.arange(6.0).reshape(2, 3) + 10 * r
                           for r in range(2)])
    for r in two:
        assert r["gather"]["backend"] == "gloo"
        for route in ("as_is", "on_host", "staged"):
            np.testing.assert_array_equal(r["gather"][route], want)


@pytest.mark.parametrize("flag,match", [
    ("production", "needs 256 ranks, the world has 2"),
    ("family", "'ssm' family does not train on a mesh of 2 ranks"),
    ("abft", "ABFT does not run on a mesh of 2 ranks")])
def test_what_a_mesh_refuses(two, flag, match):
    for r in two:
        assert match in r["refused"][flag]
