"""The tile kernels' designs, timed on the card: the 2-byte FT kernels'
checksums and, with ``--f32``, the f32 kernel's loop, with ``--mma`` the
2-byte loop's parts, with ``--batched`` the 2-byte batched step's, with
``--pruned`` the pruned mode's tile bound, with ``--int8`` the int8
kernel's.

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
    PYTHONPATH=src python -m repro_torch.launch.lloyd_profile --f32 --out DIR
    PYTHONPATH=src python -m repro_torch.launch.lloyd_profile --mma --out DIR
    PYTHONPATH=src python -m repro_torch.launch.lloyd_profile --batched \
        --out DIR
    PYTHONPATH=src python -m repro_torch.launch.lloyd_profile --pruned \
        --out DIR
    PYTHONPATH=src python -m repro_torch.launch.lloyd_profile --int8 --out DIR

``--mma`` builds the 2-byte loop's variants (``MMA_CUTS``: without the
``mma.sync`` products, without the min / argmin in registers, without the
next steps' copies, without products and min / argmin) and times
``distance_argmin`` and ``lloyd_step`` (rows 1h, 2h) at M = 2**20, F =
128, K = 1000, bf16 and fp16, interleaved.

``--pruned`` builds the pruned mode without its tile bound
(``PRUNED_CUTS``) and times ``lloyd_step_pruned`` at the sorted fit's
third step's mask and with no skips beside ``lloyd_step``, f32 and bf16.

``--batched`` builds the 2-byte batched step's variants (``BATCHED_CUTS``:
without its update, the entries' writer; without the tiles' min / argmin;
without both) and times ``fk_lloyd_step_batched_lp`` at the PQ
shape (B 48, N 65,536, F 16, K 256) at bf16 and fp16, interleaved, beside
the tree over its entries.

``--int8`` builds the int8 tile kernel's variants (``INT8_CUTS``: without
the s8 MMAs, without the distances' f32 arithmetic, without both) and
times ``distance_argmin_int8`` at M = 2**20, F = 128, K = 1000.

``--f32`` builds the f32 variants instead (``F32_CUTS``: without the next
chunk's copies (the FMAs then read stale chunks), without the FMAs,
without the min / argmin (a 64-add pass keeps the accumulator live), and
for the FT kernels without the chunk encodings, the expected checksums'
FMAs, or the tile-end observed checksums and decode) and times
``distance_argmin``, ``lloyd_step``, ``distance_argmin_ft`` and
``lloyd_step_ft`` at f32 the same way, with the f32 tile kernel's ptxas
lines and resident blocks an SM.

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
from repro_torch.kernels import distance_argmin as da
from repro_torch.kernels import distance_argmin_ft as daft
from repro_torch.kernels import lloyd_step_ft as llft

# Statements of lloyd_tile_mma_kernel's FT path, each an exact line of
# csrc/fk_kernels.cu (it must occur once) and what a cut puts in its place.
# Every cut variant also leaves out the decode (NO_DECODE).
CUTS = {
    "col": [("      P::col_fma(cs, cpitch, xencS + f0, xencS + fp + f0, ce1, "
             "ce2);\n", "")],
    "row": [("    prod.template mac<kFT>(xs, xp, cs, cpitch,\n",
             "    prod.template mac<false>(xs, xp, cs, cpitch,\n")],
    "tile": [("      prod.expected_rows(row1, row2);\n      P::col_out(part, "
              "ce1, ce2);\n", ""),
             ("        tile_min_argmin<true>(Ds + tid * (kBK + 1), cq, c0, "
              "&lmin, &larg,\n                              &o1, &o2);\n",
              "        tile_min_argmin(Ds + tid * (kBK + 1), cq, c0, &lmin, "
              "&larg);\n        o1 = o2 = 0.0f;\n"),
             ("      } else if (tid - BM < kBK) {\n        const int cc = tid "
              "- BM;",
              "      } else if (false) {\n        const int cc = tid - BM;")],
    "xenc": [("      if (q == 0) {\n        // X's encodings of the chunk",
              "      if (false) {\n        // X's encodings of the chunk")],
}
NO_DECODE = ("      if (res > thr_factor * fmaxf(mag, 1.0f)) {  // uniform\n",
             "      if (false) {\n")
# variant: the cuts it makes
VARIANTS = {"full": (), "cut_col": ("col",), "cut_row": ("row",),
            "cut_tile": ("tile",), "cut_xenc": ("xenc",),
            "cut_all": ("col", "row", "tile", "xenc")}
# The f32 lloyd_tile_kernel's parts, cut the same way (no decode cut of
# their own: "obs" takes the decode with the observed checksums).
F32_CUTS = {
    "stage": [("      if (s + 1 < nsteps) stage(s + 1);\n", "")],
    "fma": [("      for (int f1 = 0; f1 < kChunk; f1 += kU)\n",
             "      for (int f1 = 0; f1 < 0; f1 += kU)\n")],
    "epi": [("    const float lmin = tile_fold<kTM>(acc, sm + L::kCn + (q & "
             "1) * kBK, tx,\n                                      c0, &best, "
             "&best_arg);\n",
             "    const float lmin = 0.0f;\n    {\n      float t = 0.0f;\n"
             "      for (int i = 0; i < kTM; ++i)\n        for (int j = 0; j "
             "< kTN; ++j) t += acc[i][j];\n      if (t == 1.25e-38f) best = "
             "t;\n    }\n")],
    "enc": [("      if (kFT && kt == 0) {   // X's encodings",
             "      if (false) {   // X's encodings")],
    "chk": [("        if (tid < kBK) {\n#pragma unroll\n",
             "        if (false) {\n#pragma unroll\n"),
            ("        } else if (tid - kBK < BM) {\n"
             "          const float* xcol",
             "        } else if (false) {\n          const float* xcol")],
    "obs": [("      if (tid < kBK) {\n        float s1 = 0.0f, s2 = 0.0f;\n"
             "        for (int r = 0; r < BM / 2; ++r) {",
             "      if (false) {\n        float s1 = 0.0f, s2 = 0.0f;\n"
             "        for (int r = 0; r < BM / 2; ++r) {"),
            ("      } else if (tid - kBK < BM) {\n        const int r = tid "
             "- kBK;\n        const float* dr",
             "      } else if (false) {\n        const int r = tid "
             "- kBK;\n        const float* dr"),
            ("        const int d = locate_tile(sm + L::kCol1,",
             "        li = lj = 0;\n        dl = 0.0f;\n"
             "        const int d = false && locate_tile(sm + L::kCol1,")],
}
F32_VARIANTS = {"full": (), "cut_stage": ("stage",), "cut_fma": ("fma",),
                "cut_epi": ("epi",), "cut_enc": ("enc",),
                "cut_chk": ("chk",), "cut_obs": ("obs",)}
# The 2-byte tile kernel's loop (lloyd_tile_mma_kernel): its products (an
# integer xor of the loaded fragments in place of each mma.sync keeps the
# ldmatrix loads live), the tile's min / argmin in registers (the row's
# first column kept live, and a label spread over the tile's columns as the
# real ones are, so an update's work stays alike), the next steps' copies
# (the MMAs then read the ring's stale slots).
SCAN_CUT = ("      prod.scan(cq, xch);\n",
            "      if (lane % 4 == 0)\n"
            "        for (int i = 0; i < P::kMF; ++i)\n"
            "          for (int h = 0; h < 2; ++h) {\n"
            "            const int row = (warp / 4) * P::kWM + 16 * i + "
            "lane / 4 + 8 * h;\n"
            "            xch[(warp % 4) * BM + row] = make_float2(cq[0] - "
            "2.0f * prod.acc[i][0][2 * h], __int_as_float((row * 37 + mt * "
            "11 + warp) & (kBK - 1)));\n"
            "          }\n")
MMA_CUTS = {
    "mma": [("          mma_16816<T>(acc[i][j], a, b[j][0], b[j][1]);\n",
             "          acc[i][j][0] += __int_as_float(int((a[0] ^ b[j][0] ^ "
             "b[j][1]) & 1u));\n")],
    "scan": [SCAN_CUT],
    "stage": [("    issue(s + kMmaStages - 1, !kFT || (s + kMmaStages - 1) / "
               "nch == q);\n", "    cp_async_commit();\n")],
}
MMA_VARIANTS = {"full": (), "cut_mma": ("mma",), "cut_scan": ("scan",),
                "cut_stage": ("stage",), "cut_mma_scan": ("mma", "scan")}
# The 2-byte batched step's parts (kBatchedEntries): its update (the
# entries' writer) and the tile's min / argmin.
BATCHED_CUTS = {
    "update": [("    if (kUpd == kBatchedEntries) o.row0 = size_t(blockIdx.y)"
                " * gridDim.x * BM;\n",
                "    if (kUpd == kBatchedEntries) return;\n")],
    "scan": [SCAN_CUT],
}
# The pruned mode's tile bound (both kernels): without the owners' row
# bounds a computed tile's tmin is a stale minimum, so what the cut saves is
# the bound's exposed time.
PRUNED_CUTS = {
    "bound": [("    if constexpr (kPruned) {\n      // the tile's bound",
               "    if constexpr (false) {\n      // the tile's bound"),
              ("        if (kPruned) {\n          // the row's Euclidean",
               "        if (false) {\n          // the row's Euclidean")],
}
PRUNED_VARIANTS = {"full": (), "cut_bound": ("bound",)}
BATCHED_VARIANTS = {"full": (), "cut_update": ("update",),
                    "cut_scan": ("scan",), "cut_both": ("update", "scan")}
# The int8 tile kernel's parts: the s8 MMAs (an integer xor of the loaded
# fragments in their place keeps the ldmatrix loads live) and the
# distances' f32 arithmetic (the accumulator's bits scanned as they are).
INT8_CUTS = {
    "mma": [("          mma_s8_16832(acc[i][j], a, b[j][0], b[j][1]);\n",
             "          acc[i][j][0] ^= int(a[0] ^ b[j][0] ^ b[j][1]);\n")],
    "arith": [("            const float w = __fmul_rn(\n"
               "                sxr, __fmul_rn(__int2float_rn(acc[i][j][2 * h "
               "+ e]),\n                               scr[j][e]));\n"
               "            const float d = __fsub_rn(cnr[j][e], "
               "__fmul_rn(2.0f, w));\n",
               "            const float d = __int_as_float(acc[i][j][2 * h + "
               "e]);\n")],
}
INT8_VARIANTS = {"full": (), "cut_mma": ("mma",), "cut_arith": ("arith",),
                 "cut_both": ("mma", "arith")}
M, F, K = 1 << 20, 128, 1000
# the batched step's shape: the PQ codebooks (chip_smoke.py phases 6-7, 14)
B_PQ, N_PQ, F_PQ, K_PQ = 48, 65_536, 16, 256


def variant_source(src: Path, cuts: tuple, table: dict = CUTS,
                   extra: tuple = (NO_DECODE,)) -> str:
    """``src`` with the statements of ``cuts`` (of ``table``; and the
    ``extra`` pairs, the 2-byte decode) replaced; a statement that is not
    in the source exactly once fails."""
    text = src.read_text()
    for old, new in [pair for cut in cuts for pair in table[cut]] + list(
            extra):
        if text.count(old) != 1:
            raise RuntimeError(f"cut anchor found {text.count(old)} times, "
                               f"not once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(mode: str = "ft") -> dict:
    """Each variant of ``mode`` (``ft``, ``f32``, ``mma``, ``batched``,
    ``pruned`` or ``int8``): its
    library, built in parallel into the package's ``_build/`` directory
    (named by variant and source hash)."""
    src, base = _build._paths("fk_kernels")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    variants, table, extra = {
        "ft": (VARIANTS, CUTS, (NO_DECODE,)),
        "f32": (F32_VARIANTS, F32_CUTS, ()),
        "mma": (MMA_VARIANTS, MMA_CUTS, ()),
        "batched": (BATCHED_VARIANTS, BATCHED_CUTS, ()),
        "pruned": (PRUNED_VARIANTS, PRUNED_CUTS, ()),
        "int8": (INT8_VARIANTS, INT8_CUTS, ())}[mode]
    for name, cuts in variants.items():
        out = base.with_name(f"{base.stem}-{name}.so")
        vsrc = src
        if cuts:
            vsrc = out.with_suffix(".cu")
            vsrc.write_text(variant_source(src, cuts, table, extra))
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
        # the dtype code of the 2-byte entry points; None: the f32 ones
        self.half = _build.HALF_KINDS.get(str(dt).replace("torch.", ""))
        mp, fp = self.plan.xp.shape
        kp, bm = self.cp.shape[0], self.params.block_m
        nt = mp // bm
        self.mp, self.fp, self.kp, self.bm, self.nt = mp, fp, kp, bm, nt
        self.factor = ops.threshold_factor(fp, dt)
        if self.half is None:    # f32: the pre-pass's ct and encodings
            self.ct, self.cenc = da.prep_centroids(self.cp, encodings=True)
        else:
            self.cenc = daft.encode_centroids(self.cp)
        f32, i32 = dict(dtype=torch.float32, device="cuda"), dict(
            dtype=torch.int32, device="cuda")
        self.mind = torch.empty(mp, **f32)
        self.am = torch.empty(mp, **i32)
        self.det = torch.empty(nt, **i32)
        self.entries = torch.empty((mp + 1, fp), **f32)
        self.ecnt = torch.empty(mp + 1, **f32)
        self.idx = torch.empty((kp, 1 << up.tree_levels(nt)), **i32)
        self.ekey = torch.empty(mp + 1, **i32)
        self.spare = torch.empty(2, **i32)
        self.ucheck = torch.empty((nt, 2, fp), **f32)
        self.ccheck = torch.empty((nt, 2), **f32)

    def run(self, lib, kind: str, inj=None, factor=None) -> None:
        """One launch of ``kind``: ``assign``, ``lloyd``, ``assign_ft``,
        ``lloyd_ft``, ``pruned`` (at ``self.skip``) or ``pruned0`` (no
        skips), through ``lib``'s entry point of the step's dtype."""
        x, cn = self.plan.xp, self.cn
        c = self.cp if self.half is not None else self.ct
        factor = self.factor if factor is None else factor
        if inj is None:
            inj = (daft if kind == "assign_ft" else llft).no_injection()
            inj = inj.cuda()
        lp = "" if self.half is None else "_lp"
        tail = (self.mp, self.kp, self.fp, self.bm, self.params.block_f) + (
            () if self.half is None else (self.half,)) + (
            _build.stream_of(x),)
        head = (x.data_ptr(), c.data_ptr(), cn.data_ptr())
        out = (self.mind.data_ptr(), self.am.data_ptr())
        ent = (self.entries.data_ptr(), self.ecnt.data_ptr(),
               self.idx.data_ptr())
        if kind not in ("assign", "assign_ft"):
            self.idx.fill_(-1)
            self.spare.fill_(-1)
        fn = getattr(lib.lib, {"assign": "fk_distance_argmin",
                               "lloyd": "fk_lloyd_step",
                               "assign_ft": "fk_distance_argmin_ft",
                               "lloyd_ft": "fk_lloyd_step_ft"}.get(
            kind, "fk_lloyd_step_pruned") + lp)
        if kind == "assign":
            err = fn(*head, *out, *tail)
        elif kind == "lloyd":
            err = fn(*head, *out, *ent, self.plan.m, *tail)
        elif kind == "assign_ft":
            err = fn(*head, self.cenc.data_ptr(), inj.data_ptr(), *out,
                     self.det.data_ptr(), factor, *tail)
        elif kind == "lloyd_ft":
            err = fn(*head, self.cenc.data_ptr(), inj.data_ptr(), *out,
                     self.det.data_ptr(), *ent, self.ekey.data_ptr(),
                     self.spare.data_ptr(), self.ucheck.data_ptr(),
                     self.ccheck.data_ptr(), factor, self.plan.m, *tail)
        else:
            skip = self.skip if kind == "pruned" else torch.zeros_like(
                self.skip)
            err = fn(*head, self.xn.data_ptr(), skip.data_ptr(), *out, *ent,
                     self.tmin.data_ptr(), self.plan.m, *tail)
        if err:
            raise RuntimeError(f"{self.dt} {kind}: CUDA error {err}")

    def set_mask(self, skip: torch.Tensor) -> None:
        """The pruned launches' skip mask, the rows' norms and the bounds'
        buffer."""
        self.skip = skip.contiguous()
        self.xn = torch.nn.functional.pad(
            self.plan.xn, (0, self.mp - self.plan.m)).contiguous()
        self.tmin = torch.empty(skip.shape, dtype=torch.float32,
                                device="cuda")


def event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(step: Step, libs: dict, rounds: int, reps: int,
                   kinds=("assign", "assign_ft", "lloyd_ft")) -> dict:
    """Each (variant, launch)'s ms: the median over ``rounds`` rounds, each
    timing every variant's launches in turn (one warm-up each)."""
    times: dict = {}
    for _ in range(rounds):
        for name, lib in libs.items():
            for kind in kinds:
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


def f32_ptxas(log: str) -> dict:
    """ptxas' registers and spills of each f32 tile kernel."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = None
            if "17lloyd_tile_kernel" in ln:
                name = ln.split("17lloyd_tile_kernel")[1].split("EEv")[0]
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def main_f32(args, libs: dict, emit) -> None:
    """The f32 split: each variant's four launches, interleaved (the
    pre-pass runs once, outside the timed launches)."""
    emit({"device": torch.cuda.get_device_name(0),
          "build_s": max(lib.build_seconds for lib in libs.values()),
          "ptxas": {name: f32_ptxas(lib.ptxas_log)
                    for name, lib in libs.items()},
          "blocks_per_sm": {f"bm{bm}_ft{ft}_upd{u}": da.tile_resources(
              bm, bool(ft), u, F) for bm in (64, 128)
              for ft, u in ((0, 0), (0, 2), (0, 1), (1, 0), (1, 2))}})
    x_np, _ = make_blobs(M, F, K, seed=0)
    x = torch.from_numpy(x_np).cuda()
    del x_np
    gen = torch.Generator().manual_seed(0)
    c = x[torch.randperm(M, generator=gen)[:K].cuda()]
    step = Step(x, c, torch.float32)
    full = libs["full"]
    plain_labels = outcome(step, full, "assign")[0]
    fault = ops.plan_injection_tile(M, K, F, step.params, row=M // 3,
                                    col=K - 3, f_step=1,
                                    delta=2.0 ** 20).cuda()
    det = {}
    for kind, inj in (("assign_ft", None), ("assign_ft", fault),
                      ("lloyd_ft", None)):
        labels, n = outcome(step, full, kind, inj)
        det[f"{kind}{'_fault' if inj is not None else ''}"] = {
            "labels_equal_unprotected": bool(torch.equal(labels,
                                                         plain_labels)),
            "det": n}
    # the SM clock and power while the launches run (nvidia-smi every
    # 100 ms): the FMA bound's rate depends on the clock the card holds
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ms = interleaved_ms(step, libs, args.rounds, args.reps,
                            ("assign", "lloyd", "assign_ft", "lloyd_ft"))
    finally:
        smi.terminate()
        samples = smi.communicate()[0].strip().splitlines()
    clocks = [[float(v) for v in ln.split(",")] for ln in samples
              if ln.count(",") == 2]
    emit({"dtype": "float32", "m": M, "f": F, "k": K, "full": det,
          "sm_clock_mhz": statistics.median([r[0] for r in clocks])
          if clocks else None,
          "sm_clock_max_mhz": clocks[0][1] if clocks else None,
          "power_w": statistics.median([r[2] for r in clocks])
          if clocks else None,
          "ms": ms})


def main_batched(args, libs: dict, emit) -> None:
    """The 2-byte batched step's split at the PQ shape: each variant's
    launch (``fk_lloyd_step_batched_lp``) interleaved, beside the tree over
    the full build's entries (``update.reduce_entries``)."""
    import numpy as np
    x = torch.from_numpy(np.stack([make_blobs(N_PQ, F_PQ, K_PQ, seed=i)[0]
                                   for i in range(B_PQ)])).cuda()
    gen = torch.Generator().manual_seed(0)
    c = torch.stack([xi[torch.randperm(N_PQ, generator=gen)[:K_PQ].cuda()]
                     for xi in x])
    params = ops.clamp_params(N_PQ, K_PQ, F_PQ, ops.DEFAULT_PARAMS)
    bm = params.block_m
    for dt in (torch.bfloat16, torch.float16):
        plan, cp, cn, _ = ops._resolve_padded_batched(
            ops.plan_data_batched(x.to(dt), params), c, None)
        nb, mp, fp = plan.xp.shape
        kp, nt = cp.shape[1], mp // bm
        half = _build.HALF_KINDS[str(dt).replace("torch.", "")]
        f32, i32 = dict(dtype=torch.float32, device="cuda"), dict(
            dtype=torch.int32, device="cuda")
        mind, am = torch.empty((nb, mp), **f32), torch.empty((nb, mp), **i32)
        entries = torch.empty((nb * mp, fp), **f32)
        ecnt = torch.empty(nb * mp, **f32)
        idx = torch.empty((nb * kp, 1 << up.tree_levels(nt)), **i32)

        def run(lib):
            idx.fill_(-1)
            err = lib.lib.fk_lloyd_step_batched_lp(
                plan.xp.data_ptr(), cp.data_ptr(), cn.data_ptr(),
                mind.data_ptr(), am.data_ptr(), entries.data_ptr(),
                ecnt.data_ptr(), idx.data_ptr(), N_PQ, nb, mp, kp, fp, bm,
                params.block_f, half, _build.stream_of(plan.xp))
            if err:
                raise RuntimeError(f"batched: CUDA error {err}")
        times: dict = {}
        for _ in range(args.rounds):
            for name, lib in libs.items():
                run(lib)
                times.setdefault(name, []).append(
                    event_ms(lambda: run(lib), args.reps))
        run(libs["full"])
        fill_ms = event_ms(lambda: idx.fill_(-1), args.reps)
        run(libs["full"])

        def tree():
            return up.reduce_entries(entries, ecnt, idx, ntiles=nt)
        tree()      # the tree kernel's library is built at first use
        emit({"dtype": str(dt).replace("torch.", ""), "b": nb, "n": N_PQ,
              "f": F_PQ, "k": K_PQ, "bm": bm,
              "present_entries": int((idx >= 0).sum()),
              "idx_fill_ms": fill_ms,
              "ms": {k: statistics.median(v) for k, v in times.items()},
              "tree_over_entries_ms": event_ms(tree, args.reps)})
        del plan, cp, cn, entries, ecnt, idx
        torch.cuda.empty_cache()


def mma_ptxas(log: str) -> dict:
    """ptxas' registers and spills of each 2-byte tile kernel."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = None
            if "lloyd_tile_mma_kernel" in ln:
                name = ln.split("lloyd_tile_mma_kernel")[1].split("EEv")[0]
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def main_mma(args, libs: dict, emit) -> None:
    """The 2-byte loop's split at M = 2**20, F = 128, K = 1000: each
    variant's ``distance_argmin`` and ``lloyd_step`` (rows 1h, 2h) at bf16
    and fp16, interleaved; the full build's labels against the cut ones'
    are not read (a cut's outputs are void)."""
    emit({"device": torch.cuda.get_device_name(0),
          "build_s": max(lib.build_seconds for lib in libs.values()),
          "ptxas": {name: mma_ptxas(lib.ptxas_log)
                    for name, lib in libs.items()}})
    x_np, _ = make_blobs(M, F, K, seed=0)
    x = torch.from_numpy(x_np).cuda()
    del x_np
    gen = torch.Generator().manual_seed(0)
    c = x[torch.randperm(M, generator=gen)[:K].cuda()]
    for dt in (torch.bfloat16, torch.float16):
        step = Step(x, c, dt)
        emit({"dtype": str(dt).replace("torch.", ""), "m": M, "f": F,
              "k": K, "ms": interleaved_ms(step, libs, args.rounds,
                                           args.reps, ("assign", "lloyd"))})
        del step
        torch.cuda.empty_cache()


def main_pruned(args, libs: dict, emit) -> None:
    """The pruned mode at M = 2**20, F = 128, K = 1000 with rows sorted by
    label, at the sorted fit's third step's mask (two pruned steps from
    each label's first row): ``lloyd_step_pruned`` at that mask and with no
    skips beside ``lloyd_step``, f32 and bf16, each variant interleaved;
    the full build's no-skip step against ``lloyd_step`` bit for bit."""
    from repro_torch.core.kmeans import means_from_sums
    x_np, labels_np = make_blobs(M, F, K, seed=0)
    order = torch.from_numpy(labels_np).argsort(stable=True)
    x = torch.from_numpy(x_np)[order].cuda()
    lab = torch.from_numpy(labels_np)[order].cuda()
    del x_np, labels_np
    first = torch.searchsorted(lab, torch.arange(K, device=lab.device,
                                                 dtype=lab.dtype))
    for dt in (torch.float32, torch.bfloat16):
        params = ops.clamp_params(M, K, F, ops.DEFAULT_PARAMS)
        plan = ops.plan_data(x.to(dt), params)
        c, bounds = x[first], None
        for _ in range(2):
            _, _, sums, counts, bounds, _ = ops.fused_lloyd_pruned(
                plan, c, params, bounds=bounds)
            c = means_from_sums(sums, counts, c)
        del plan
        step = Step(x, c, dt)
        skip, _ = ops.prune_mask(bounds, step.cp, M, params)
        step.set_mask(skip)
        full = libs["full"]
        step.run(full, "pruned0")
        pruned0 = (step.mind.clone(), step.am.clone())
        step.run(full, "lloyd")
        bitwise = bool(torch.equal(pruned0[0], step.mind)
                       and torch.equal(pruned0[1], step.am))
        emit({"dtype": str(dt).replace("torch.", ""), "m": M, "f": F,
              "k": K, "skipped": float(skip.float().mean()),
              "no_skip_bitwise_lloyd_step": bitwise,
              "ms": interleaved_ms(step, libs, args.rounds, args.reps,
                                   ("pruned", "pruned0", "lloyd"))})
        del step, bounds, sums, counts
        torch.cuda.empty_cache()


def main_int8(args, libs: dict, emit) -> None:
    """The int8 tile kernel's split at M = 2**20, F = 128, K = 1000: each
    variant's launch (``fk_distance_argmin_int8``, BM = 128) interleaved,
    the full build's outputs bit for bit the plain version's."""
    from repro_torch.kernels import distance_argmin_int8 as dai
    x_np, _ = make_blobs(M, F, K, seed=0)
    x = torch.from_numpy(x_np).cuda()
    del x_np
    gen = torch.Generator().manual_seed(0)
    c = x[torch.randperm(M, generator=gen)[:K].cuda()]
    params = ops.clamp_params(M, K, F, ops.DEFAULT_PARAMS)
    plan, cq, sc, cn, _ = ops._resolve_padded_int8(x, c, params)
    mp, fp = plan.xq.shape
    mind = torch.empty(mp, dtype=torch.float32, device="cuda")
    am = torch.empty(mp, dtype=torch.int32, device="cuda")

    def run(lib):
        err = lib.lib.fk_distance_argmin_int8(
            plan.xq.data_ptr(), cq.data_ptr(), plan.sx.data_ptr(),
            sc.data_ptr(), cn.data_ptr(), mind.data_ptr(), am.data_ptr(), mp,
            cq.shape[0], fp, params.block_m, _build.stream_of(cq))
        if err:
            raise RuntimeError(f"int8: CUDA error {err}")
    run(libs["full"])
    want = dai.distance_argmin_int8_plain(plan.xq, cq, plan.sx, sc, cn)
    bitwise = bool(torch.equal(mind, want[0]) and torch.equal(am, want[1]))
    times: dict = {}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            run(lib)
            times.setdefault(name, []).append(event_ms(lambda: run(lib),
                                                       args.reps))
    emit({"m": M, "f": F, "k": K, "bm": params.block_m,
          "full_bitwise_plain": bitwise,
          "ms": {k: statistics.median(v) for k, v in times.items()}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "lloyd_profile"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--f32", action="store_true",
                    help="the f32 kernel's split instead of the 2-byte one")
    ap.add_argument("--mma", action="store_true",
                    help="the 2-byte loop's split (rows 1h, 2h)")
    ap.add_argument("--batched", action="store_true",
                    help="the 2-byte batched step's split")
    ap.add_argument("--pruned", action="store_true",
                    help="the pruned mode's bound, beside lloyd_step")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 tile kernel's split")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    mode = ("f32" if args.f32 else "mma" if args.mma
            else "batched" if args.batched else "pruned" if args.pruned
            else "int8" if args.int8 else "ft")
    libs = build_variants(mode)
    # the port's own library is the full variant: same source and flags
    _build._LIBS["fk_kernels"] = libs["full"]
    results = []

    def emit(rec: dict) -> None:
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if mode != "ft":
        {"f32": main_f32, "mma": main_mma, "batched": main_batched,
         "pruned": main_pruned, "int8": main_int8}[mode](args, libs, emit)
        (out / "results.json").write_text(json.dumps(results, indent=1))
        return 0

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
