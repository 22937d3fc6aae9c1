"""Device time by kernel of the DMR centroid update, the f32 flash prefill
and the attention backward, on the card (``torch.profiler``):

    PYTHONPATH=src python -m repro_torch.launch.kernel_split [--cases ...]

``dmr``: ``centroid_update_dmr`` at M = 2**20, F = 128, K = 1000
(``make_blobs`` rows and their generating labels, then every row in
cluster 3): the memset and its six launches (histogram, scan, scatter,
gather, slab sums, verdict), ms a call over 10 calls. ``f32``:
``flash_attention`` at f32 at internlm2-1.8b's prefill (B 4, H 16, KV 8,
S 2048, hd 128, causal; seeded normal q, k, v), ms a call over 3 calls.
``backward``: ``flash_attention_backward`` at internlm2-1.8b's training
micro-batch (B 2, H 16, KV 8, S 4096, hd 128, causal, bf16; seeded
normal q, k, v, dO, the forward kernel's output and lse), its kernels' ms
a call over 10 calls, beside SDPA's backward (``torch.autograd.grad`` of
``scaled_dot_product_attention``) traced the same way, and both as CUDA-
event ms a call. The backward case uses only the wrappers' names, so the
script also times another tree's kernels: ``PYTHONPATH=<tree>/src python3
src/repro_torch/launch/kernel_split.py --cases backward``. Prints one
JSON object a case: kernel name -> device ms a call. Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json


def device_ms(fn, calls: int) -> dict:
    """Device time a call of each kernel ``fn`` launches, after a warm-up
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.device_time_total > 0:
            out[e.key] = e.device_time_total / calls / 1e3
    return out


def event_ms(fn, calls: int) -> float:
    """Mean CUDA-event ms of a call of ``fn``, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def dmr() -> None:
    import torch
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import centroid_update_dmr as cud
    x, lab = make_blobs(1 << 20, 128, 1000, seed=0)
    x = torch.from_numpy(x).cuda()
    lab = torch.from_numpy(lab).cuda().to(torch.int32)
    one = torch.full_like(lab, 3)
    for name, a in (("dmr_blob_labels", lab), ("dmr_one_cluster", one)):
        print(json.dumps({name: device_ms(
            lambda: cud.centroid_update_dmr(x, a, 1000), 10)}), flush=True)


def f32() -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, kv, s, hd = 4, 16, 8, 2048, 128
    q = torch.randn(b, h, s, hd, generator=gen, device="cuda") * hd ** -0.5
    k = torch.randn(b, kv, s, hd, generator=gen, device="cuda")
    v = torch.randn(b, kv, s, hd, generator=gen, device="cuda")
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    print(json.dumps({"flash_f32_prefill": device_ms(
        lambda: fa.flash_attention(q, k, v, pos, pos), 3)}), flush=True)


def backward() -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, kv, s, hd = 2, 16, 8, 4096, 128

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    q = (draw(b, h, s, hd) * hd ** -0.5).to(torch.bfloat16)
    k, v = (draw(b, kv, s, hd).to(torch.bfloat16) for _ in range(2))
    do = draw(b, h, s, hd).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    out, lse = fa._launch(q, k, v, pos, pos, True, 0, True, with_lse=True)

    def ours():
        return fa.flash_attention_backward(q, k, v, out, do, lse, pos, pos)
    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, scale=1.0,
                                       enable_gqa=True)

    def sdpa():
        return torch.autograd.grad(o, (qq, kk, vv), do, retain_graph=True)
    print(json.dumps({"flash_backward": device_ms(ours, 10),
                      "flash_backward_event_ms": event_ms(ours, 20),
                      "sdpa_backward": device_ms(sdpa, 10),
                      "sdpa_backward_event_ms": event_ms(sdpa, 20),
                      "device": torch.cuda.get_device_name(0)}), flush=True)


# each case and the sources it builds
CASES = {"dmr": (dmr, ("fk_kernels",)), "f32": (f32, ("fk_attention",)),
         "backward": (backward, ("fk_attention", "fk_attention_bwd"))}


def main(argv=None) -> None:
    import torch
    from repro_torch.kernels import _build, ref
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", choices=tuple(CASES),
                    default=list(CASES))
    args = ap.parse_args(argv)
    ref.full_f32(torch.device("cuda"))
    _build.build(*{src for name in args.cases for src in CASES[name][1]})
    for name in args.cases:
        CASES[name][0]()


if __name__ == "__main__":
    main()
