"""Serving launcher: micro-batched prefill + greedy decode on one device.

The port of ``repro.launch.serve``, for every arch of ``ARCH_IDS``. The
request queue rides the generic micro-batching layer,
:class:`~repro_torch.serve.MicroBatcher`. Each request submits its ``(1,
prompt_len)`` prompt; the batcher coalesces a wave into one
row-concatenated batch, the dispatch function pads it to the fixed batch,
runs prefill + greedy decode once, and the batcher scatters each request
its generated row. Weights are drawn from seed 0, as the
reference draws them from ``PRNGKey(0)``. As there, whisper's wave gets
zero ``audio_embeds`` (batch, encoder_seq, d_model) and qwen2-vl's zero
``patch_embeds`` (batch, num_patches, d_model), f32.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --no-smoke --requests 8 --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --smoke --device cpu --requests 2 --batch 2 --prompt-len 8 --gen 4

The reference's ``--smoke`` is ``store_true`` with ``default=True``, so it
can never build a full config; here ``--no-smoke`` does. ``main`` returns
the run's figures (prefill and decode seconds per wave, measured with a
device synchronise at each phase boundary, and the flash kernel's launches
by kernel) for callers such as ``chip_smoke.py``, and prints prefill ms a
wave, decode ms a step and tokens/s.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import LM
from repro_torch.models.model import greedy
from repro_torch.serve import MicroBatcher


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def frontend_inputs(cfg, batch: int, device) -> dict:
    """The stub frontends' inputs of one wave, as the reference's launcher
    gives them: zero audio frames (whisper), zero patch embeddings
    (qwen2-vl), f32; an empty dict for text-only archs."""
    out = {}
    if cfg.frontend == "audio_stub":
        out["audio_embeds"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
            device=device)
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = torch.zeros(
            (batch, cfg.num_patches, cfg.d_model), dtype=torch.float32,
            device=device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-4b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    lm = LM(cfg, device=args.device, seed=0)
    dev = lm.device
    max_len = args.prompt_len + args.gen
    stats = {"prefill_s": [], "decode_s": [], "decode_steps": 0}

    def generate(prompts):
        """One coalesced wave: pad rows to the batch, prefill + greedy
        decode, return the generated ``(rows, gen)`` tokens (sliced back so
        the batcher can scatter per request) and whether every logit of the
        wave was finite."""
        rows = prompts.shape[0]
        if rows < args.batch:              # pad the tail wave
            prompts = np.concatenate(
                [prompts, np.repeat(prompts[-1:], args.batch - rows, 0)])
        batch = frontend_inputs(cfg, args.batch, dev)
        batch["tokens"] = torch.as_tensor(prompts, dtype=torch.int32,
                                          device=dev)
        t0 = _clock(dev)
        logits, caches = lm.prefill(batch, max_len=max_len)
        tok = greedy(logits)
        finite = torch.isfinite(logits).all()
        t1 = _clock(dev)
        generated = [tok]
        for t in range(args.prompt_len, max_len - 1):
            logits, caches = lm.decode_step(caches, tok, t)
            tok = greedy(logits)
            finite &= torch.isfinite(logits).all()
            generated.append(tok)
        t2 = _clock(dev)
        stats["prefill_s"].append(t1 - t0)
        stats["decode_s"].append(t2 - t1)
        stats["decode_steps"] += len(generated) - 1
        return torch.cat(generated, dim=1)[:rows], finite

    launches0 = dict(fa.flash_attention.kernel_launches)
    batcher = MicroBatcher(generate)
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab_size, size=(1, args.prompt_len))
             for _ in range(args.requests)]
    prompts = np.concatenate(queue) if queue else None
    served, total_tokens, finite, outs = 0, 0, True, []
    t0 = time.time()
    with torch.no_grad():
        while queue:
            wave, queue = queue[:args.batch], queue[args.batch:]
            tickets = [batcher.submit(p) for p in wave]
            batcher.flush()
            for tk in tickets:
                rows, ok = tk.result()
                total_tokens += rows.shape[1]
                finite = finite and bool(ok)
                outs.append(rows)
            served += len(wave)
            print(f"served {served}/{args.requests} requests")
    dt = time.time() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    flash = {name: n - launches0[name]
             for name, n in fa.flash_attention.kernel_launches.items()}
    prefill_ms = [1e3 * t for t in stats["prefill_s"]]
    decode_ms = 1e3 * sum(stats["decode_s"]) / max(stats["decode_steps"], 1)
    print(f"{args.arch}: prefill {', '.join(f'{t:.1f}' for t in prefill_ms)}"
          f" ms a wave, decode {decode_ms:.2f} ms a step, flash launches "
          f"{flash}")
    print(f"{total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s greedy, {where})")
    return dict(stats, served=served, requests=args.requests,
                prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
                tokens_per_s=total_tokens / dt, flash_launches=flash,
                tokens=total_tokens, seconds=dt, finite=finite,
                prompts=prompts,
                generated=torch.cat(outs).numpy() if outs else None)


if __name__ == "__main__":
    main()
