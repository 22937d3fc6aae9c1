"""Device time by kernel of the DMR centroid update and the f32 flash
prefill, on the card (``torch.profiler``):

    PYTHONPATH=src python -m repro_torch.launch.kernel_split

``centroid_update_dmr`` at M = 2**20, F = 128, K = 1000 (``make_blobs``
rows and their generating labels, then every row in cluster 3): the
memset and its six launches (histogram, scan, scatter, gather, slab sums,
verdict), ms a call over 10 calls; ``flash_attention`` at f32 at
internlm2-1.8b's prefill (B 4, H 16, KV 8, S 2048, hd 128, causal;
seeded normal q, k, v), ms a call over 3 calls. Prints one JSON object a
case: kernel name -> device ms a call. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

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


def main() -> None:
    import torch
    from repro_torch.data.blobs import make_blobs
    from repro_torch.kernels import _build
    from repro_torch.kernels import centroid_update_dmr as cud
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    ref.full_f32(torch.device("cuda"))
    _build.build_all()
    x, lab = make_blobs(1 << 20, 128, 1000, seed=0)
    x = torch.from_numpy(x).cuda()
    lab = torch.from_numpy(lab).cuda().to(torch.int32)
    one = torch.full_like(lab, 3)
    for name, a in (("dmr_blob_labels", lab), ("dmr_one_cluster", one)):
        print(json.dumps({name: device_ms(
            lambda: cud.centroid_update_dmr(x, a, 1000), 10)}), flush=True)
    del x
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, kv, s, hd = 4, 16, 8, 2048, 128
    q = torch.randn(b, h, s, hd, generator=gen, device="cuda") * hd ** -0.5
    k = torch.randn(b, kv, s, hd, generator=gen, device="cuda")
    v = torch.randn(b, kv, s, hd, generator=gen, device="cuda")
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    print(json.dumps({"flash_f32_prefill": device_ms(
        lambda: fa.flash_attention(q, k, v, pos, pos), 3)}), flush=True)


if __name__ == "__main__":
    main()
