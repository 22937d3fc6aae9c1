"""The 2-byte FT tile kernels' checksum design, timed on the card.

Builds ``csrc/fk_kernels.cu`` as it is (``full``) and, from copies of it
with statements cut (``CUTS``), measurement variants (``cut_*``: without
the expected column checksums' FMAs, the row checksums' MMA, the tile-end
checksums and residuals, the first tile's X encodings, or all four, and
each without the decode; what a cut saves is that part's exposed time,
its detections are void), one nvcc each, at once. The shipped source
carries no measurement switch. At M = 2**20, F = 128, K = 1000
(``make_blobs``, centroids drawn from the rows by a seeded permutation),
bf16 and fp16, it times ``distance_argmin`` (no checksums: the product's
floor), ``distance_argmin_ft`` and ``lloyd_step_ft`` of each library,
interleaved round by round (CUDA events, median of the rounds), and reads
the full build's labels and detections, clean and with a planted distance
fault, and its clean residual margin (log2 of the threshold over the
largest clean residual, bisected).

    PYTHONPATH=src python -m repro_torch.launch.lloyd_profile --out DIR

Needs a CUDA card and ``nvcc``; prints one JSON object a measurement and
writes them under ``--out`` (by default the package's git-ignored
``_build/lloyd_profile``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.data.blobs import make_blobs
from repro_torch.kernels import _build, ops, update as up
from repro_torch.kernels import distance_argmin_ft as daft
from repro_torch.kernels import lloyd_step_ft as llft

# Statements of lloyd_tile_mma_kernel's FT path, each an exact line of
# csrc/fk_kernels.cu (it must occur once) and what a cut puts in its place.
# Every cut variant also leaves out the decode (NO_DECODE).
CUTS = {
    "col": [("        P::col_fma(sm, enc, ce1, ce2);\n", "")],
    "row": [("      prod.template mac<kFT>(sm);\n",
             "      prod.template mac<false>(sm);\n")],
    "tile": [("    if (kFT) {\n      prod.expected_rows(",
              "    if (false) {\n      prod.expected_rows("),
             ("    if (kFT) {\n      // the observed checksums",
              "    if (false) {\n      // the observed checksums")],
    "xenc": [("        if (kt == 0) {\n          // X's encodings",
              "        if (false) {\n          // X's encodings")],
}
NO_DECODE = ("      if (res > thr_factor * fmaxf(mag, 1.0f)) {  // uniform\n",
             "      if (false) {\n")
# variant: the cuts it makes
VARIANTS = {"full": (), "cut_col": ("col",), "cut_row": ("row",),
            "cut_tile": ("tile",), "cut_xenc": ("xenc",),
            "cut_all": ("col", "row", "tile", "xenc")}
M, F, K = 1 << 20, 128, 1000


def variant_source(src: Path, cuts: tuple) -> str:
    """``src`` with the statements of ``cuts`` (and the decode) replaced;
    a statement that is not in the source exactly once fails."""
    text = src.read_text()
    for old, new in [pair for cut in cuts for pair in CUTS[cut]] + [NO_DECODE]:
        if text.count(old) != 1:
            raise RuntimeError(f"cut anchor found {text.count(old)} times, "
                               f"not once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """Each variant's library, built in parallel into the package's
    ``_build/`` directory (named by variant and source hash)."""
    src, base = _build._paths("fk_kernels")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, cuts in VARIANTS.items():
        out = base.with_name(f"{base.stem}-{name}.so")
        vsrc = src
        if cuts:
            vsrc = out.with_suffix(".cu")
            vsrc.write_text(variant_source(src, cuts))
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
        libs[name] = _build._load("fk_kernels", out,
                                  time.perf_counter() - t0)
    return libs


class Step:
    """The padded inputs of one dtype and the outputs and scratch of the
    three launches, made once; ``run(lib, kind, ...)`` launches one."""

    def __init__(self, x: torch.Tensor, c: torch.Tensor, dt):
        self.params = ops.clamp_params(M, K, F, ops.DEFAULT_PARAMS)
        self.plan, self.cp, self.cn, _ = ops._resolve_padded(
            ops.plan_data(x.to(dt), self.params), c, None)
        self.dt = dt
        self.half = _build.HALF_KINDS[str(dt).replace("torch.", "")]
        mp, fp = self.plan.xp.shape
        kp, bm = self.cp.shape[0], self.params.block_m
        nt = mp // bm
        self.mp, self.fp, self.kp, self.bm, self.nt = mp, fp, kp, bm, nt
        self.factor = ops.threshold_factor(fp, dt)
        self.cenc = daft.encode_centroids(self.cp)
        f32, i32 = dict(dtype=torch.float32, device="cuda"), dict(
            dtype=torch.int32, device="cuda")
        self.mind = torch.empty(mp, **f32)
        self.am = torch.empty(mp, **i32)
        self.det = torch.empty(nt, **i32)
        self.xenc = torch.empty((nt, 2, fp), **f32)
        self.entries = torch.empty((mp + 1, fp), **f32)
        self.ecnt = torch.empty(mp + 1, **f32)
        self.idx = torch.empty((kp, 1 << up.tree_levels(nt)), **i32)
        self.ekey = torch.empty(mp + 1, **i32)
        self.spare = torch.empty(2, **i32)
        self.ucheck = torch.empty((nt, 2, fp), **f32)
        self.ccheck = torch.empty((nt, 2), **f32)

    def run(self, lib, kind: str, inj=None, factor=None) -> None:
        x, c, cn = self.plan.xp, self.cp, self.cn
        s = _build.stream_of(x)
        bf = self.params.block_f
        factor = self.factor if factor is None else factor
        if inj is None:
            inj = (daft if kind == "assign_ft" else llft).no_injection()
            inj = inj.cuda()
        if kind == "assign":
            err = lib.lib.fk_distance_argmin_lp(
                x.data_ptr(), c.data_ptr(), cn.data_ptr(),
                self.mind.data_ptr(), self.am.data_ptr(), self.mp, self.kp,
                self.fp, self.bm, bf, self.half, s)
        elif kind == "assign_ft":
            err = lib.lib.fk_distance_argmin_ft_lp(
                x.data_ptr(), c.data_ptr(), cn.data_ptr(),
                self.cenc.data_ptr(), inj.data_ptr(), self.mind.data_ptr(),
                self.am.data_ptr(), self.det.data_ptr(),
                self.xenc.data_ptr(), factor, self.mp, self.kp, self.fp,
                self.bm, bf, self.half, s)
        else:
            self.idx.fill_(-1)
            self.spare.fill_(-1)
            err = lib.lib.fk_lloyd_step_ft_lp(
                x.data_ptr(), c.data_ptr(), cn.data_ptr(),
                self.cenc.data_ptr(), inj.data_ptr(), self.mind.data_ptr(),
                self.am.data_ptr(), self.det.data_ptr(),
                self.xenc.data_ptr(), self.entries.data_ptr(),
                self.ecnt.data_ptr(), self.idx.data_ptr(),
                self.ekey.data_ptr(), self.spare.data_ptr(),
                self.ucheck.data_ptr(), self.ccheck.data_ptr(), factor,
                self.plan.m, self.mp, self.kp, self.fp, self.bm, bf,
                self.half, s)
        if err:
            raise RuntimeError(f"{kind}: CUDA error {err}")


def event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(step: Step, libs: dict, rounds: int, reps: int) -> dict:
    """Each (variant, launch)'s ms: the median over ``rounds`` rounds, each
    timing every variant's three launches in turn (one warm-up each)."""
    times: dict = {}
    for _ in range(rounds):
        for name, lib in libs.items():
            for kind in ("assign", "assign_ft", "lloyd_ft"):
                step.run(lib, kind)
                times.setdefault(f"{name}/{kind}", []).append(
                    event_ms(lambda: step.run(lib, kind), reps))
    return {key: statistics.median(ts) for key, ts in times.items()}


def outcome(step: Step, lib, kind: str, inj=None, factor=None) -> tuple:
    step.run(lib, kind, inj, factor)
    return step.am.clone(), int(step.det.sum())


def margin_log2(step: Step, lib, steps: int = 12) -> list:
    """[lo, hi): log2 of the threshold over the largest clean residual of
    ``distance_argmin_ft``'s tiles (the factor lowered by 2^-e, e bisected
    in [0, 40], until a clean launch detects)."""
    def det(e):
        return outcome(step, lib, "assign_ft",
                       factor=step.factor * 2.0 ** -e)[1]
    if det(0.0):
        return [float("-inf"), 0.0]
    lo, hi = 0.0, 40.0
    if not det(hi):
        return [hi, float("inf")]
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if det(mid):
            hi = mid
        else:
            lo = mid
    return [lo, hi]


def ft_ptxas(log: str) -> dict:
    """ptxas' registers and spills of each 2-byte FT tile kernel (mangled
    names shortened to their template arguments)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = None
            if "lloyd_tile_mma_kernel" in ln and "ELb1E" in ln:
                name = ln.split("lloyd_tile_mma_kernel")[1].split("EEv")[0]
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "lloyd_profile"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    libs = build_variants()
    # the port's own library is the full variant: same source and flags
    _build._LIBS["fk_kernels"] = libs["full"]
    results = []

    def emit(rec: dict) -> None:
        results.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"device": torch.cuda.get_device_name(0),
          "build_s": max(lib.build_seconds for lib in libs.values()),
          "ptxas": {name: ft_ptxas(lib.ptxas_log)
                    for name, lib in libs.items()}})
    x_np, _ = make_blobs(M, F, K, seed=0)
    x = torch.from_numpy(x_np).cuda()
    del x_np
    gen = torch.Generator().manual_seed(0)
    c = x[torch.randperm(M, generator=gen)[:K].cuda()]
    for dt in (torch.bfloat16, torch.float16):
        step = Step(x, c, dt)
        fault = ops.plan_injection_tile(M, K, F, step.params, row=M // 3,
                                        col=K - 3, f_step=1,
                                        delta=2.0 ** 20).cuda()
        full = libs["full"]
        plain_labels = outcome(step, full, "assign")[0]
        det = {}
        for kind, inj in (("assign_ft", None), ("assign_ft", fault),
                          ("lloyd_ft", None)):
            labels, n = outcome(step, full, kind, inj)
            key = f"{kind}{'_fault' if inj is not None else ''}"
            det[key] = {"labels_equal_unprotected":
                        bool(torch.equal(labels, plain_labels)),
                        "det": n}
        emit({"dtype": str(dt).replace("torch.", ""), "m": M, "f": F,
              "k": K, "full": det,
              "clean_margin_log2": margin_log2(step, full),
              "ms": interleaved_ms(step, libs, args.rounds, args.reps)})
        del step
        torch.cuda.empty_cache()
    (out / "results.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
