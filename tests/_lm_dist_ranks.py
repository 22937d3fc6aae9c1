"""Rank bodies of the sharded LM tests (``test_torch_lm_sharding.py``).

``repro_torch.dist.sharding.run_ranks`` spawns each rank from a fresh
interpreter that imports the rank's function by module, so the bodies live
here, in a module that imports torch and the port only. Every body returns
numpy arrays and plain numbers. Each builds its ``DeviceMesh``es first, on
every rank, in one order.
"""
import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM, attention
from repro_torch.train import build_train_step, init_opt_state, steps
from repro_torch.train.optimizer import TrainConfig

ARCH = "internlm2-1.8b"
LR = 1e-3
ROWS, SEQ = 4, 16
# attend's cases: (causal, window, positions' start)
ATTEND = {"causal": (True, 0, 0), "window": (True, 5, 0),
          "bidirectional": (False, 0, 40)}
ATTEND_SHAPE = (2, 16, 4, 2, 8)         # B, S, H, KV, hd


def smoke_config(dtype: str = "float32"):
    return dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                               param_dtype=dtype)


def train_config(accum: int) -> TrainConfig:
    return TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10,
                       grad_accum=accum)


def batch(cfg, seed: int = 9) -> dict:
    """One global batch, numpy int32 (the same on every rank)."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(ROWS, SEQ + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _numpy(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _model(dtype: str, state: dict, mesh) -> LM:
    lm = LM(smoke_config(dtype), device="cpu")
    lm.load_state_dict(state)
    return shd.shard_params(mesh, lm, lm.param_axes())


def gradients(lm, mesh, b: dict, *, thread: bool = False) -> dict:
    """{name: whole gradient} of ``lm.loss`` on the global batch ``b``
    through the step's pieces (the placed batch, the active mesh);
    ``thread`` runs the backward on another thread, as autograd runs the
    card's: that thread carries DTensor's implicit replication (autograd
    hands its worker the caller's dispatch state) but not the mesh."""
    lm.requires_grad_(True)
    placed = steps._placed_batch(mesh, b, torch.device("cpu"))
    with shd.mesh_as(mesh):
        loss, _ = lm.loss(placed)
        if thread:
            errors = []

            def backward():
                try:
                    with shd.plain_as_replicated():
                        loss.backward()
                except Exception as e:     # noqa: BLE001 - raised below
                    errors.append(e)
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
            if errors:
                raise errors[0]
        else:
            loss.backward()
    out = {n: _numpy(steps._grad(p)) for n, p in lm.named_parameters()}
    for p in lm.parameters():
        p.grad = None
    return out


def _step(lm, mesh, dtype: str, accum: int) -> tuple[dict, dict]:
    cfg = smoke_config(dtype)
    tcfg = train_config(accum)
    opt = init_opt_state(dict(lm.named_parameters()), tcfg)
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=ROWS, kind="train")
    m = build_train_step(cfg, shape, tcfg, device="cpu", mesh=mesh)(
        lm, opt, _torch(batch(cfg)))
    return ({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "params": {n: _numpy(p) for n, p in lm.named_parameters()}},
            opt)


def attend_inputs(case: str) -> dict:
    b, s, h, kv, hd = ATTEND_SHAPE
    rng = np.random.default_rng(11)
    out = {k: rng.standard_normal((b, s, n, hd)).astype(np.float32)
           for k, n in (("q", h), ("k", kv), ("v", kv), ("g", h))}
    out["positions"] = np.arange(s, dtype=np.int32) + ATTEND[case][2]
    return out


def attend_plain(case: str) -> dict:
    """``_attend_local`` on the whole tensors, and its gradients."""
    x = attend_inputs(case)
    q, k, v = (torch.from_numpy(x[n]).requires_grad_() for n in "qkv")
    pos = torch.from_numpy(x["positions"])
    causal, window, _ = ATTEND[case]
    out = attention._attend_local(q, k, v, q_positions=pos, kv_positions=pos,
                                  causal=causal, window=window,
                                  chunk=attention.Q_CHUNK)
    (out * torch.from_numpy(x["g"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _attend_branch(mesh, case: str) -> dict:
    """``attend`` on whole-tensor ``DTensor``s over ``mesh``: the branch
    splits the queries over ``model``."""
    x = attend_inputs(case)
    full = [Replicate()] * mesh.ndim
    q, k, v = (distribute_tensor(torch.from_numpy(x[n]), mesh, full,
                                 src_data_rank=None).requires_grad_()
               for n in "qkv")
    g = distribute_tensor(torch.from_numpy(x["g"]), mesh, full,
                          src_data_rank=None)
    pos = torch.from_numpy(x["positions"])
    causal, window, _ = ATTEND[case]
    with shd.mesh_as(mesh):
        out = attention.attend(q, k, v, q_positions=pos, kv_positions=pos,
                               causal=causal, window=window)
    (out * g).sum().backward()
    return {"out": _numpy(out), "dq": _numpy(q.grad), "dk": _numpy(k.grad),
            "dv": _numpy(v.grad)}


def _unsummed(fn, *args):
    """``fn`` with ``attend``'s k / v gradients claimed replicated over
    ``model`` instead of partial (the control)."""
    keep = attention.Partial
    attention.Partial = Replicate
    try:
        return fn(*args)
    finally:
        attention.Partial = keep


def four_ranks(rank, world, dev, states):
    """On ``make_local_mesh(2)`` (data 2, model 2) from ``states`` ({dtype:
    state dict}): the f32 gradients (backward here, on another thread, and
    with k / v unsummed), one f32 AdamW step at 1 and 2 micro-batches, the
    same under a forced ZeRO-3 layout, one bf16 step; on
    ``make_local_mesh(4)`` (model 4) ``attend``'s cases and the unsummed
    control."""
    mesh = make_local_mesh(2, device="cpu")
    mesh4 = make_local_mesh(4, device="cpu")
    f32 = _torch(batch(smoke_config()))
    out: dict = {}
    lm = _model("float32", states["float32"], mesh)
    out["placements"] = {n: str(p.placements)
                         for n, p in lm.named_parameters()}
    out["grads"] = gradients(lm, mesh, f32)
    out["grads_thread"] = gradients(lm, mesh, f32, thread=True)
    out["grads_unsummed"] = _unsummed(gradients, lm, mesh, f32)
    out["float32/1"], opt = _step(lm, mesh, "float32", 1)
    out["m_placements"] = {n: str(t.placements) for n, t in opt["m"].items()}
    out["float32/2"], _ = _step(_model("float32", states["float32"], mesh),
                                mesh, "float32", 2)
    out["bfloat16/1"], _ = _step(_model("bfloat16", states["bfloat16"],
                                        mesh), mesh, "bfloat16", 1)
    keep = shd._FSDP_MIN_SIZE
    shd._FSDP_MIN_SIZE = 0
    try:
        lm = _model("float32", states["float32"], mesh)
    finally:
        shd._FSDP_MIN_SIZE = keep
    out["fsdp_placements"] = {n: str(p.placements)
                              for n, p in lm.named_parameters()}
    out["grads_fsdp"] = gradients(lm, mesh, f32)
    out["fsdp/1"], opt = _step(lm, mesh, "float32", 1)
    out["fsdp/1"]["m"] = {n: _numpy(t) for n, t in opt["m"].items()}
    out["attend"] = {case: _attend_branch(mesh4, case) for case in ATTEND}
    out["attend"]["unsummed"] = _unsummed(_attend_branch, mesh4, "causal")
    return out


def two_ranks(rank, world, dev, args, mesh_dir, single_dir):
    """The launcher on 2 ranks (``make_local_mesh()``: data 2): ``main``
    for 3 steps with a snapshot at step 3 into ``mesh_dir``; that snapshot
    and the single-device one in ``single_dir`` restored on the mesh; the
    runs a mesh of 2 refuses."""
    from repro_torch.ft import Checkpointer
    from repro_torch.launch import train as launch
    out = {"records": launch.main(args + ["--ckpt-every", "3",
                                          "--ckpt-dir", mesh_dir])}
    for key, where in (("mesh_restored", mesh_dir), ("restored",
                                                     single_dir)):
        run = launch.setup(launch.parse(args + ["--ckpt-dir", where]))
        st = Checkpointer(where, group=dist.group.WORLD).restore()
        launch.load_state(run["lm"], run["opt"], st)
        out[key] = {n: _numpy(p) for n, p in run["lm"].named_parameters()}
        out[key + "_m"] = _numpy(run["opt"]["m"]["layers.0.mix.wq"])
    name = dist.group.WORLD.group_name
    mine = torch.arange(6.0).reshape(2, 3) + 10 * rank
    wait = torch.ops._c10d_functional.wait_tensor
    out["gather"] = {
        "backend": shd._group_backend(name),
        "as_is": _numpy(wait(shd._gather_as_is(mine, world, name))),
        "on_host": _numpy(shd._gather_on_host(mine, world, name)),
        "staged": _numpy(wait(shd._staged_gather(mine, world, name)))}
    out["refused"] = {}
    for flag, extra in (("production", ["--production-mesh"]),
                        ("family", ["--arch", "mamba2-1.3b"]),
                        ("abft", ["--abft"])):
        try:
            launch.setup(launch.parse(args + extra))
            out["refused"][flag] = "no error"
        except (ValueError, NotImplementedError) as e:
            out["refused"][flag] = str(e)
    return out
