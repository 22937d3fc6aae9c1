"""The attention backward kernels' time split, on the card: what the dK /
dV and dQ kernels of ``csrc/fk_attention_bwd.cu`` spend on their
products, their exponentials and their copies.

Builds ``csrc/fk_attention_bwd.cu`` as it is (``full``) and, from copies of
it with statements cut (``CUTS``), measurement variants, one nvcc each, at
once: ``cut_mma`` without the four (dK / dV) or three (dQ) ``wgmma``
products (P and dS still formed, from stale accumulators, and kept live),
``cut_exp`` without the exponentials of P (``ex2`` on the SFU), ``cut_loads``
without the walk's TMA copies of Q and dO (dK / dV) or K and V (dQ) (the
products read stale tiles; the ring's barriers still turn), ``cut_mma_loads``
without both: what is left is the walk, the barriers and the elementwise
work. What a cut saves is that part's exposed time; the variants' results
are void. The shipped source carries no measurement switch. At
internlm2-1.8b's training micro-batch (B 2, H 16, KV 8, S 4096, hd 128,
causal, bf16; seeded normal inputs, the forward kernel's output and lse) it
times ``flash_bwd_dkdv`` and ``flash_bwd_dq`` of each library, interleaved
round by round (CUDA events, median of the rounds):

    PYTHONPATH=src python -m repro_torch.launch.bwd_profile [--rounds N]

Needs a CUDA card and ``nvcc``; prints one JSON object: each variant's
median ms a launch of each kernel and its ptxas lines.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

from repro_torch.kernels import _build

_PP = ("      for (int i = 0; i < 8; ++i)\n"
       "        asm volatile(\"\" ::\"r\"(pp[i][0]), \"r\"(pp[i][1]), "
       "\"r\"(sp[i][0]), \"r\"(sp[i][1]));\n")
_SP = ("      for (int i = 0; i < 8; ++i)\n"
       "        asm volatile(\"\" ::\"r\"(sp[i][0]), \"r\"(sp[i][1]));\n")
CUTS = {
    "mma": [
        ("      wgmma_abt<T, HD>(sa, Kw, kBlock * 128, Qt, kTile * 128);\n"
         "      wgmma_abt<T, HD>(pa, Vw, kBlock * 128, Gt, kTile * 128);\n",
         ""),
        ("      wgmma_ab<T, HD>(dva, pp, Gt);\n"
         "      wgmma_ab<T, HD>(dka, sp, Qt);\n", _PP),
        ("      wgmma_abt<T, HD>(sa, Qw, kBlock * 128, Kt, kTile * 128);\n"
         "      wgmma_abt<T, HD>(pa, Gw, kBlock * 128, Vt, kTile * 128);\n",
         ""),
        ("      wgmma_ab<T, HD>(dqa, sp, Kt);\n", _SP)],
    "exp": [
        ("fast_exp2((sa[nt * 4 + 2 * r] - l2.x) * kLog2e)",
         "((sa[nt * 4 + 2 * r] - l2.x) * kLog2e)"),
        ("fast_exp2((sa[nt * 4 + 2 * r + 1] - l2.y) * kLog2e)",
         "((sa[nt * 4 + 2 * r + 1] - l2.y) * kLog2e)"),
        ("fast_exp2((sa[nt * 4 + 2 * r + e] - lr[r]) * kLog2e)",
         "((sa[nt * 4 + 2 * r + e] - lr[r]) * kLog2e)")],
    "loads": [
        ("        unsigned char* Qs = smw + W::ring + st * W::stage_bytes;\n"
         "        mbar_expect_tx(full + st, W::stage_bytes);\n",
         "        unsigned char* Qs = smw + W::ring + st * W::stage_bytes;\n"
         "        mbar_arrive(full + st);\n"),
        ("          tma_load(Qs + p * kTile * 128, &qmap, full + st, p * 64,\n"
         "                   qt * kTile, h, b);\n"
         "          tma_load(Qs + W::tile_bytes + p * kTile * 128, &gmap, "
         "full + st,\n"
         "                   p * 64, qt * kTile, h, b);\n", ""),
        ("          unsigned char* Ks = smw + W::ring + st * W::stage_bytes;\n"
         "          mbar_expect_tx(full + st, W::stage_bytes);\n",
         "          unsigned char* Ks = smw + W::ring + st * W::stage_bytes;\n"
         "          mbar_arrive(full + st);\n"),
        ("            tma_load(Ks + p * kTile * 128, &kmap, full + st, p * 64,\n"
         "                     t * kTile, kvh, b);\n"
         "            tma_load(Ks + W::tile_bytes + p * kTile * 128, &vmap, "
         "full + st,\n"
         "                     p * 64, t * kTile, kvh, b);\n", "")],
}
VARIANTS = {"full": (), "cut_mma": ("mma",), "cut_exp": ("exp",),
            "cut_loads": ("loads",), "cut_mma_loads": ("mma", "loads")}


def variant_source(text: str, cuts: tuple) -> str:
    """The source with the statements of ``cuts`` replaced; a statement
    that is not in the source exactly once fails."""
    for old, new in [pair for cut in cuts for pair in CUTS[cut]]:
        if text.count(old) != 1:
            raise RuntimeError(f"cut anchor found {text.count(old)} times, "
                               f"not once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """Each variant's library, built in parallel into the package's
    ``_build/`` directory (named by variant and source hash)."""
    src, base = _build._paths("fk_attention_bwd")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    t0 = time.perf_counter()
    procs = {}
    for name, cuts in VARIANTS.items():
        out = base.with_name(f"{base.stem}-{name}.so")
        vsrc = src
        if cuts:
            vsrc = out.with_suffix(".cu")
            vsrc.write_text(variant_source(text, cuts))
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{src.parent}",
             "-o", str(out), str(vsrc)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{stderr}")
        out.with_suffix(".log").write_text(stdout + stderr)
        libs[name] = _build._load("fk_attention_bwd", out,
                                  time.perf_counter() - t0)
    return libs


def event_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, kv, s, hd = 2, 16, 8, 4096, 128

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    q = (draw(b, h, s, hd) * hd ** -0.5).to(torch.bfloat16)
    k, v = (draw(b, kv, s, hd).to(torch.bfloat16) for _ in range(2))
    do = draw(b, h, s, hd).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    out, lse = fa._launch(q, k, v, pos, pos, True, 0, True, with_lse=True)
    kernels = {
        "dkdv": lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, dsum, pos, pos),
        "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, dsum, pos, pos)}
    real = _build._LIBS.get("fk_attention_bwd")
    times = {name: {kern: [] for kern in kernels} for name in libs}
    try:
        _build._LIBS["fk_attention_bwd"] = libs["full"]
        dsum = fa.flash_bwd_prep(q, k, v, do, lse, pos, pos)
        for _ in range(args.rounds):
            for name, lib in libs.items():
                _build._LIBS["fk_attention_bwd"] = lib
                for kern, fn in kernels.items():
                    times[name][kern].append(event_ms(fn, args.reps))
    finally:
        if real is None:
            _build._LIBS.pop("fk_attention_bwd", None)
        else:
            _build._LIBS["fk_attention_bwd"] = real
    ptxas = {name: [ln.strip() for ln in lib.ptxas_log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, lib in libs.items()}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "shape": [b, h, kv, s, s, hd], "rounds": args.rounds,
        "median_ms": {name: {kern: statistics.median(t)
                             for kern, t in ts.items()}
                      for name, ts in times.items()},
        "ms": times, "ptxas": ptxas}), flush=True)


if __name__ == "__main__":
    main()
