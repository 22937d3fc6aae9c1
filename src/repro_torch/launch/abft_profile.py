"""Where the ABFT GEMM's time goes, on the card, at bf16, fp16 and f32.

Builds ``csrc/fk_abft_gemm.cu`` as it is and in measurement variants (the
source's ``FK_ABFT_CUT`` and ``FK_ABFT_RING`` macros, which the port's own
build never sets), one nvcc per variant, all at once, and times each
variant's GEMM kernel alone (CUDA events, the encodings computed once
beforehand) on the same inputs, the variants interleaved round by round:

* ``full``: the kernel as the port builds it;
* ``no_store``, ``no_colsum``, ``no_verify``: without the D stores, the
  column checksum products, or the verification epilogue (their D is
  wrong; what each saves is that part's exposed time);
* ``product``: without all three (the loads and the ``wgmma`` products;
  at f32 also the in-register split of X and the partials' adds; at f32
  ``no_colsum`` cuts nothing: the expected checksums are the
  pre-pass's);
* ``deep``, ``wide``: each ring configuration forced, at several K, to
  test the rule that picks one at 2 bytes (their D and detections must
  equal ``full``'s bit for bit; f32 has the deep ring only).

Beside them, the encodings pre-pass alone (``prepass_ms``; at f32 it also
writes Y's three bf16 planes and computes the expected checksums). It also
traces one ``ops.abft_matmul`` call per shape with ``torch.profiler``: the
device time of the encodings pre-pass and of the GEMM, and the card's idle
share within the call.

    PYTHONPATH=src python -m repro_torch.launch.abft_profile \\
        --out chiprun_out/abft_profile

Needs a CUDA card and ``nvcc``; prints one JSON object a measurement and
writes them, with the traces, under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import matmul_abft as mma

# variant: nvcc defines
VARIANTS = {
    "full": (),
    "no_store": ("-DFK_ABFT_CUT=1",),
    "no_colsum": ("-DFK_ABFT_CUT=2",),
    "no_verify": ("-DFK_ABFT_CUT=4",),
    "product": ("-DFK_ABFT_CUT=7",),
    "deep": ("-DFK_ABFT_RING=1",),
    "wide": ("-DFK_ABFT_RING=2",),
}
SPLIT = ("full", "no_store", "no_colsum", "no_verify", "product")
# (name, m, k, n): the row-10h shapes (a) and (b); the ring rule's K at
# (a)'s m and n, tiles (128, 128, 64) (ops.abft_tiles pads K to 128, so 192
# is reached through the raw entry only)
SHAPES = (("a", 1 << 20, 128, 1000), ("b", 8192, 2048, 8192))
RING_K = (128, 192, 256, 512)
RING_TILES = (128, 128, 64)


def build_variants(names) -> dict:
    """Each variant's library, built in parallel into the package's
    ``_build/`` directory (named by variant and source hash)."""
    src, base = _build._paths("fk_abft_gemm")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = base.with_name(f"{base.stem}-{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *VARIANTS[name], "-o",
             str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{stderr}")
        out.with_suffix(".log").write_text(stdout + stderr)
        libs[name] = _build._load("fk_abft_gemm", out,
                                  time.perf_counter() - t0)
    return libs


class Gemm:
    """One (m, k, n, dtype) problem at ``tiles`` (``ops.abft_tiles``'
    by default), padded, with its encodings (and at f32 Y's planes),
    output and workspace made once."""

    def __init__(self, m: int, k: int, n: int, dt, seed: int, tiles=None):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        y = torch.randn(k, n, generator=gen, device="cuda").to(dt)
        self.bm, self.bn, self.bk = tiles or ops.abft_tiles(m, n, k)
        self.mp = -(-m // self.bm) * self.bm
        self.np = -(-n // self.bn) * self.bn
        self.kp = -(-k // self.bk) * self.bk
        self.x = ops._pad_to(x, self.mp, self.kp)
        self.y = ops._pad_to(y, self.kp, self.np)
        self.xg, self.yg = x, y
        self.kind = mma.GEMM_KINDS[str(dt).replace("torch.", "")]
        self.factor = ops.threshold_factor(self.kp, dt)
        self.inj = mma.no_injection().cuda()
        self.ex, self.ey, self.op, *checks = mma.abft_encodings(
            self.x, self.y, block_m=self.bm, block_n=self.bn)
        # the kernel's operands: at 2 bytes y, E_X and the split E_Y; at
        # f32 Y's planes and the expected row and column checksums
        self.checks = checks
        self.yb, self.ea, self.eb = ((self.op, checks[1], checks[0])
                                     if checks else (self.y, self.ex, self.op))
        self.ws = mma._gemm_workspace(self.x.device, self.bm, self.bn)
        self.d = torch.empty(self.mp, self.np, device="cuda")
        self.det = torch.empty(self.mp // self.bm, self.np // self.bn,
                               dtype=torch.int32, device="cuda")

    def launch(self, lib) -> None:
        err = lib.lib.fk_abft_gemm(
            self.x.data_ptr(), self.yb.data_ptr(), self.inj.data_ptr(),
            self.ea.data_ptr(), self.eb.data_ptr(), self.d.data_ptr(),
            self.det.data_ptr(), self.ws.data_ptr(), self.ws.numel(),
            self.factor, self.mp, self.np, self.kp, self.bm, self.bn,
            self.bk, self.kind, _build.stream_of(self.x))
        if err:
            raise RuntimeError(f"fk_abft_gemm: CUDA error {err}")

    def encode(self, lib) -> None:
        """The encodings pre-pass into this problem's buffers."""
        checks = [c.data_ptr() for c in self.checks] or [0, 0]
        err = lib.lib.fk_abft_encode(
            self.x.data_ptr(), self.y.data_ptr(), self.ex.data_ptr(),
            self.ey.data_ptr(), self.op.data_ptr(), *checks, self.mp,
            self.np, self.kp, self.bm, self.bn, self.kind,
            _build.stream_of(self.x))
        if err:
            raise RuntimeError(f"fk_abft_encode: CUDA error {err}")


def event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(g: Gemm, libs: dict, rounds: int, reps: int) -> dict:
    """Each variant's ms a launch: the median over ``rounds`` rounds, each
    timing every variant in turn (``reps`` launches after one warm-up)."""
    times = {name: [] for name in libs}
    for _ in range(rounds):
        for name, lib in libs.items():
            g.launch(lib)
            times[name].append(event_ms(lambda: g.launch(lib), reps))
    return {name: statistics.median(ts) for name, ts in times.items()}


def same_result(g: Gemm, a, b) -> bool:
    """Whether libraries ``a`` and ``b`` give bitwise-equal D and
    detections on ``g``."""
    g.launch(a)
    d, det = g.d.clone(), g.det.clone()
    g.launch(b)
    return bool(torch.equal(d, g.d)) and bool(torch.equal(det, g.det))


def trace(g: Gemm, out: Path, tag: str) -> dict:
    """One ``ops.abft_matmul`` call under ``torch.profiler``: each kernel's
    device ms, the card's busy time and its idle share of the traced
    wall time; the Chrome trace goes to ``out``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ops.abft_matmul(g.xg, g.yg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops.abft_matmul(g.xg, g.yg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(out / f"trace_{tag}.json"))
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    per_name: dict = {}
    for start, end, name in dev:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        key = name[:60]
        per_name[key] = per_name.get(key, 0.0) + (end - start) / 1e3
    busy_ms = busy_us / 1e3
    return {"device_ms": per_name, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if dev else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/abft_profile")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtypes", default="bfloat16,float16,float32",
                    help="comma-separated input dtypes to profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    libs = build_variants(VARIANTS)
    # the port's own library is the full variant: same source and flags
    _build._LIBS["fk_abft_gemm"] = libs["full"]
    results = []

    def emit(rec: dict) -> None:
        results.append(rec)
        print(json.dumps(rec), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "build_s": max(lib.build_seconds for lib in libs.values())})
    for dtype in args.dtypes.split(","):
        dt = getattr(torch, dtype)
        for tag, m, k, n in SHAPES:
            g = Gemm(m, k, n, dt, seed=0)
            ms = interleaved_ms(g, {v: libs[v] for v in SPLIT}, args.rounds,
                                args.reps)
            g.encode(libs["full"])
            prepass = event_ms(lambda: g.encode(libs["full"]), args.reps)
            emit({"split": tag, "dtype": dtype, "m": m, "k": k, "n": n,
                  "tiles": [g.bm, g.bn, g.bk], "ms": ms,
                  "prepass_ms": prepass,
                  "trace": trace(g, out, f"{tag}_{dtype}")})
            del g
            torch.cuda.empty_cache()
        for k in (RING_K if dt != torch.float32 else ()):
            g = Gemm(SHAPES[0][1], k, SHAPES[0][3], dt, seed=1,
                     tiles=RING_TILES)
            ring = {v: libs[v] for v in ("full", "deep", "wide")}
            equal = all(same_result(g, libs["full"], libs[v])
                        for v in ("deep", "wide"))
            emit({"ring": k, "dtype": dtype, "tiles": [g.bm, g.bn, g.bk],
                  "ms": interleaved_ms(g, ring, args.rounds, args.reps),
                  "bitwise_equal": equal})
            if not equal:
                raise SystemExit(f"ring configurations differ at K {k}")
            del g
            torch.cuda.empty_cache()
    (out / "results.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
