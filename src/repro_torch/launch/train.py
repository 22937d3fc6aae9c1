"""Training launcher: --arch <id> on one device or a mesh of ranks.

The port of ``repro.launch.train``: seeded init, the micro-batched AdamW
step (``repro_torch.train.build_train_step``), the synthetic token
pipeline, asynchronous atomic checkpoints and ``--restore`` for fail-stop
recovery, the ABFT switch, the straggler observation hook
(``ft.elastic.StragglerPolicy``, each rank's step time against the median
of its last 20). Weights are drawn from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --device cpu --steps 10 [--abft] [--restore]
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --batch 8 --grad-accum 4 --steps 5 --ckpt-every 0
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --smoke --device cpu --backend gloo --steps 10

Under torchrun (``WORLD_SIZE`` > 1) the process group is made with
``--backend`` (gloo or nccl, as given: nothing switches over; nccl takes
one card a rank, gloo lets ranks share one) unless the caller made one
already, and the model trains on ``make_local_mesh()`` over the world
(data-parallel), or with ``--production-mesh`` on the reference's (16, 16)
mesh, ``--multi-pod`` (2, 16, 16); the parameters are placed after init
(``sharding.shard_params``) and ``--restore`` copies each rank's shard of
the snapshot into them (``load_state``); rank 0 writes the snapshots and
prints the step lines.

``--batch`` and ``--seq`` cut the shape's global batch and sequence (one
card holds internlm2-1.8b's train_4k step at a global batch of about 8 x
4096, not 256), ``--layers`` the decoder's depth (an arch whose weights,
gradients and f32 moments pass one card's 80 GB); ``--grad-accum``
overrides the reference launcher's 2 micro-batches. A vision- or
audio-stub arch's batches carry the frontend embeddings of the
reference's ``input_specs`` (``data.synthetic.frontend_embeds``). ``--ckpt-every 0`` writes no snapshot at all (at full width
one is ~22 GB). ``main`` returns the run's per-step records for callers
such as ``chip_smoke.py``; ``setup(parse(argv))`` gives the model, state
and step that ``main`` starts from.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.estimator import resolve_device
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, train_schedule
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.dist import sharding as shd
from repro_torch.ft.checkpoint import Checkpointer, flatten
from repro_torch.ft.elastic import StragglerPolicy
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import LM
from repro_torch.train.optimizer import TrainConfig, init_opt_state
from repro_torch.train.steps import build_train_step, check_mesh_supported


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train_state(lm, opt: dict) -> dict:
    """The checkpointed state: {"params": {name: p}, "opt": opt}."""
    return {"params": dict(lm.named_parameters()), "opt": opt}


@torch.no_grad()
def load_state(lm, opt: dict, flat: dict) -> None:
    """Copy a restored flat state into ``lm``'s parameters and ``opt`` in
    place, each value cast to its tensor's dtype (on a mesh, each rank
    keeps its shard of the whole tensor it read)."""
    for key, t in flatten(train_state(lm, opt)).items():
        full = torch.from_numpy(np.asarray(flat[key])).to(t.dtype)
        t.copy_(shd.like(t, full))


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def train_loop(lm, step_fn, opt: dict, pipe: TokenPipeline, start: int,
               steps: int, *, ck: Checkpointer | None = None,
               ckpt_every: int = 0, log=print) -> list[dict]:
    """Steps ``start`` .. ``steps - 1``; prints the reference's step lines
    (every 10th and the last) and returns one record a step: the host
    seconds (a device synchronise at each end), loss, lr and grad norm, and
    whether a ``StragglerPolicy`` would evict this rank."""
    dev = pipe.device
    straggler = StragglerPolicy()
    records, times = [], []
    for step in range(start, steps):
        t0 = _clock(dev)
        batch = pipe.next_batch(step)
        m = step_fn(lm, opt, batch)
        dt = _clock(dev) - t0
        times.append(dt)
        evict = straggler.observe(_rank(), dt,
                                  float(np.median(times[-20:])))
        rec = {"step": step, "s": dt, "loss": float(m["loss"]),
               "lr": float(m["lr"]), "grad_norm": float(m["grad_norm"]),
               "straggler": evict}
        records.append(rec)
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step:4d}  loss {rec['loss']:.4f}  "
                f"lr {rec['lr']:.2e}  gnorm {rec['grad_norm']:.2f}  "
                f"{dt:.2f}s")
        if ck is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            ck.save(step + 1, train_state(lm, opt))
    return records


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--shape", choices=tuple(SHAPES), default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--abft", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=0,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--layers", type=int, default=0,
                    help="decoder layers (default: the config's; a cut of "
                         "depth where the state does not fit one card)")
    ap.add_argument("--grad-accum", type=int, default=0,
                    help="micro-batches a step (default: the config's "
                         "override, else 2)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="steps between snapshots; 0: none")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl",
                    help="the process group's backend under torchrun")
    return ap.parse_args(argv)


def _mesh(args: argparse.Namespace, device: str):
    """The process group (torchrun's, when WORLD_SIZE > 1 and the caller
    made none) and the run's mesh: None for a world of one rank."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(shd.rank_device(
                device, int(os.environ.get("LOCAL_RANK", "0"))))
        dist.init_process_group(args.backend)
    if args.production_mesh:
        return make_production_mesh(multi_pod=args.multi_pod, device=device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        return make_local_mesh(device=device)
    return None


def setup(args: argparse.Namespace) -> dict:
    """What a run of ``args`` starts from: the config, shape and train
    config, the mesh, the step, the seeded model (seed 0, placed on the
    mesh) and its zero optimizer state, the token pipeline."""
    mesh = _mesh(args, args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.abft:
        cfg = dataclasses.replace(cfg, abft=True)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    check_mesh_supported(cfg, mesh)
    shape = ShapeConfig("smoke", seq_len=64, global_batch=8, kind="train") \
        if args.smoke else SHAPES[args.shape]
    if args.batch or args.seq:
        shape = dataclasses.replace(
            shape, global_batch=args.batch or shape.global_batch,
            seq_len=args.seq or shape.seq_len)
    dev = resolve_device(args.device)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                       total_steps=args.steps,
                       schedule=train_schedule(args.arch),
                       grad_accum=args.grad_accum
                       or cfg.grad_accum_override or 2,
                       opt_state_dtype=cfg.opt_state_dtype,
                       accum_dtype=cfg.opt_state_dtype)
    lm = LM(cfg, device=dev, seed=0)
    if mesh is not None:
        shd.shard_params(mesh, lm, lm.param_axes())
    return {"cfg": cfg, "shape": shape, "tcfg": tcfg, "device": dev,
            "mesh": mesh,
            "step_fn": build_train_step(cfg, shape, tcfg, device=dev,
                                        mesh=mesh),
            "lm": lm,
            "opt": init_opt_state(dict(lm.named_parameters()), tcfg),
            "pipe": TokenPipeline.for_config(cfg, shape.seq_len,
                                             shape.global_batch, device=dev)}


def main(argv=None) -> list[dict]:
    args = parse(argv)
    run = setup(args)
    cfg, shape, tcfg, lm, opt, mesh = (run[k] for k in (
        "cfg", "shape", "tcfg", "lm", "opt", "mesh"))
    log = print if _rank() == 0 else (lambda *a, **k: None)
    log(f"arch={cfg.name} device={run['device']} "
        f"mesh={None if mesh is None else shd.mesh_shape(mesh)} "
        f"schedule={tcfg.schedule} abft={cfg.abft} "
        f"params={cfg.param_count() / 1e6:.1f}M "
        f"batch={shape.global_batch}x{shape.seq_len} "
        f"grad_accum={tcfg.grad_accum}")
    start = 0
    ck = Checkpointer(args.ckpt_dir, keep=3, async_write=True,
                      group=None if mesh is None else dist.group.WORLD)
    if args.restore:
        st = ck.restore()
        if st is not None:
            start = int(st["_step"])
            load_state(lm, opt, st)
            log(f"restored checkpoint at step {start}")

    records = train_loop(lm, run["step_fn"], opt, run["pipe"], start,
                         args.steps, ck=ck, ckpt_every=args.ckpt_every,
                         log=log)
    if args.ckpt_every:
        ck.save(args.steps, train_state(lm, opt))
    ck.wait()
    log(f"done; snapshots: {ck.available_steps()}")
    return records


if __name__ == "__main__":
    main()
