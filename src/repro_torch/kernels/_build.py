"""Build and bind the port's CUDA kernels (nvcc + ctypes, no PyTorch headers).

Each ``csrc/<name>.cu`` is one shared library with a plain C interface. At
first use on a CUDA device a source is compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

into the package's git-ignored ``_build/`` directory and loaded with
``ctypes``; :func:`build_all` starts one nvcc per source, all at once.
``fk_kernels.cu`` holds every k-means kernel of the port: the tile kernel
behind ``distance_argmin``, ``lloyd_step`` (one problem, its update as
entries, or B stacked problems over a (row tile, problem) grid: at f32 the
dense update, ``fk_lloyd_step_batched``, at 2 bytes each problem's entries,
``fk_lloyd_step_batched_lp``), ``distance_argmin_ft`` and
``lloyd_step_ft`` (at 2 bytes with the C encodings' pre-pass,
``fk_lloyd_encode_lp``), the dense update epilogue launched alone
(``fk_update_tiles``), the pruned one-pass step
(``fk_lloyd_step_pruned``: the tile kernel's pruned mode, its update as
entries), each also for bf16 or fp16 inputs on the
tensor cores (the ``*_lp`` entry points of :data:`LOWP_ENTRIES`, one more
int argument before the stream: :data:`HALF_KINDS`), the k-means++ D^2
round (``fk_kmeanspp_round``), the
int8 distance kernel on the s8 tensor cores (``fk_distance_argmin_int8``;
``fk_int8_resources``, its occupancy) and the DMR centroid
update (``fk_centroid_update_dmr``: the rows bucketed by cluster, a
gather of two replicas, the slab sums and the verdict; ``fk_dmr_workspace``,
its scratch sizes). ``fk_attention.cu`` holds
the LM stack's flash attention (``fk_flash_attention``, f32, bf16 or fp16:
the prefill, decode and f32 kernels, and ``fk_flash_workspace``, the decode
kernel's workspace sizes); ``fk_attention_bwd.cu`` its gradient at bf16 /
fp16 (``fk_flash_bwd_prep``, ``fk_flash_bwd_dkdv``, ``fk_flash_bwd_dq`` on
``wgmma`` + TMA, and ``fk_flash_bwd_resources``, their occupancy);
``fk_attention_bwd_f32.cu`` the f32 gradient on the CUDA cores
(``fk_flash_bwd_f32_prep``, ``fk_flash_bwd_f32_dkdv``,
``fk_flash_bwd_f32_dq``, ``fk_flash_bwd_f32_resources``).
``fk_abft_gemm.cu`` holds the ABFT GEMM at
f32, bf16 and fp16: its encodings pre-pass (``fk_abft_encode``) and the
``wgmma`` GEMM (``fk_abft_gemm``; at f32 on a three-way bf16 split of the
operands). ``fk_update.cu`` holds the two-pass centroid update's
per-tile pass (``fk_update_entries``), the fixed-order tree sum
(``fk_tree_reduce``) and the one-pass FT step's update verification
(``fk_verify_entries``). ``fk_kernels.cu`` includes ``csrc/fk_mma.cuh`` (the
tensor-core ``mma.sync`` helpers); ``fk_kernels.cu`` and ``fk_update.cu``
include ``csrc/fk_entries.cuh`` (the per-tile entry writer and the tree's
slots); ``fk_attention.cu``, ``fk_attention_bwd.cu`` and
``fk_abft_gemm.cu`` include ``csrc/fk_tma.cuh`` (mbarriers, TMA loads, tensor maps) and
``csrc/fk_wgmma.cuh`` (the ``wgmma`` wrappers);
``fk_kernels.cu`` and ``fk_abft_gemm.cu`` include ``csrc/fk_abft.cuh``
(the ABFT decode, ``locate_tile``). A library's
file name carries a hash of its source and the headers of ``csrc/``, so an
edited source or header rebuilds and an unchanged one is reused.
Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into a ``RuntimeError``. Nothing here
runs at import time: this module is imported on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# argtypes of every C entry point of each source (pointers and the stream as
# c_void_p, so 64-bit addresses are never cut to a 32-bit int)
SIGNATURES: dict[str, tuple] = {
    "fk_distance_argmin": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "fk_lloyd_step": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P),
    "fk_distance_argmin_ft": (_P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                              _I, _I, _P),
    "fk_lloyd_step_ft": (_P,) * 15 + (_F, _I, _I, _I, _I, _I, _I, _P),
    "fk_update_tiles": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "fk_lloyd_step_batched": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _P),
    "fk_kmeanspp_round": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, c, cn, xn, skip, mind, argmin, entries, ecnt, idx, tmin; true_m,
    # mp, kp, fp, bm, bf; stream
    "fk_lloyd_step_pruned": (_P,) * 11 + (_I,) * 6 + (_P,),
    "fk_distance_argmin_int8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _P),
    # x, assign, iwork, fwork, sums, counts, bad; m, f, k, slab_rows, the
    # debug fault's slab, cluster, feature and delta; stream
    "fk_centroid_update_dmr": (_P,) * 7 + (_I,) * 7 + (_F, _P),
    # m, f, k, slab_rows and the address of 2 long longs it fills
    "fk_dmr_workspace": (_I, _I, _I, _I, _P),
    # the DMR gather kernel's resources: V (1 or 4), out (4 ints)
    "fk_dmr_resources": (_I, _P),
    # a tile kernel's resources: bm, ft, upd, fp, kp, dtype code (-1 f32,
    # else HALF_KINDS'), out (4 ints); the int8 kernel's: bm, fp, out
    "fk_tile_resources": (_I, _I, _I, _I, _I, _I, _P),
    "fk_int8_resources": (_I, _I, _P),
    # its pre-pass: c, ct, cenc (or null); nb, kp, fp; stream
    "fk_lloyd_prep": (_P, _P, _P, _I, _I, _I, _P),
}
# the 2-byte entry points: their f32 twin's arguments, then the dtype code
# (HALF_KINDS), then the stream
LOWP_ENTRIES = ("fk_distance_argmin", "fk_lloyd_step",
                "fk_distance_argmin_ft", "fk_lloyd_step_ft",
                "fk_update_tiles", "fk_lloyd_step_pruned")
SIGNATURES.update({f"{name}_lp": SIGNATURES[name][:-1] + (_I, _P)
                   for name in LOWP_ENTRIES})
# the 2-byte batched step writes entries: x, c, cn, mind, argmin, entries,
# ecnt, idx; true_m, nb, mp, kp, fp, bm, bf, dtype code; stream
SIGNATURES["fk_lloyd_step_batched_lp"] = (_P,) * 8 + (_I,) * 8 + (_P,)
# the 2-byte FT kernels' pre-pass: c, cenc; kp, fp, dtype code; stream
SIGNATURES["fk_lloyd_encode_lp"] = (_P, _P, _I, _I, _I, _P)
# dtype code of the *_lp entry points, by torch dtype name
HALF_KINDS = {"bfloat16": 0, "float16": 1}
# q, k, v, q_positions, kv_positions, out; B, H, KV, Sq, Skv, hd; the
# (batch, head, sequence) element strides of q, k, v and out; causal,
# window, zero_empty, dtype (0 f32, 1 bf16, 2 fp16); the decode kernel's
# partials and tickets; the optional f32 lse output; stream.
# fk_flash_workspace: B, H, KV, Sq, Skv, hd, dtype and the address of 4
# long longs it fills.
ATTENTION_SIGNATURES: dict[str, tuple] = {
    "fk_flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                           _I, _I, _I, _I, _P, _P, _P, _P),
    "fk_flash_workspace": (_I, _I, _I, _I, _I, _I, _I, _P),
    # the f32 kernel's resources: hd, out (4 ints)
    "fk_flash_f32_resources": (_I, _P),
}
# fk_abft_encode: x, y, ex, ey, esy (the split E_Y at 2 bytes, Y's bf16
# planes at f32), ecol and erow (f32: the expected column and row
# checksums); mp, np, kp, bm, bn, dtype code (matmul_abft.GEMM_KINDS);
# stream. fk_abft_gemm: x, Y's operand (y, or the planes at f32), inj, ex
# and the split E_Y (erow and ecol at f32), d, det, the workspace and its
# floats; the threshold factor; mp, np, kp, bm, bn, bk, dtype code; stream.
ABFT_GEMM_SIGNATURES: dict[str, tuple] = {
    "fk_abft_encode": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P),
    "fk_abft_gemm": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _F, _I, _I, _I, _I,
                     _I, _I, _I, _P),
}
# fk_update_entries: x, argmin, tile, gate, entries, ecnt, idx, ekey;
# true_m, kp, fp, block_m, ntiles, dtype (0 f32, 1 bf16, 2 fp16); stream.
# fk_tree_reduce:
# vals, idx, gate, out, out_idx; rows, slots, ntiles, rstride, tstride,
# width, threads, vec, chunk_log2; stream. fk_verify_entries: entries, ecnt,
# ekey, spare, ucheck, ccheck, verdict; block_m, ntiles, fp, the threshold
# factor; stream.
UPDATE_SIGNATURES: dict[str, tuple] = {
    "fk_update_entries": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P),
    "fk_tree_reduce": (_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I,
                       _I, _P),
    "fk_verify_entries": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
}
# the attention gradient (fk_attention_bwd.cu). fk_flash_bwd_prep: q, k,
# v, dout, lse, D (written), q_positions, kv_positions; B, H, KV, Sq, Skv,
# hd; the address of 12 long long strides ((q, k, v, dout) x (batch, head,
# sequence)); causal, window, dtype (1 bf16, 2 fp16); stream.
# fk_flash_bwd_dkdv: q, k, v, dout, lse, D, q_positions, kv_positions, dk,
# dv; B, H, KV, Sq, Skv, hd; the address of 18 strides ((q, k, v, dout, dk,
# dv) x (batch, head, sequence)); causal, window, dtype; stream.
# fk_flash_bwd_dq: the same with dq for dk, dv and 15 strides.
# fk_flash_bwd_resources: kernel (0 dK / dV, 1 dQ), dtype, hd, 6 ints out.
ATTENTION_BWD_SIGNATURES: dict[str, tuple] = {
    "fk_flash_bwd_prep": (_P,) * 8 + (_I,) * 6 + (_P, _I, _I, _I, _P),
    "fk_flash_bwd_dkdv": (_P,) * 10 + (_I,) * 6 + (_P, _I, _I, _I, _P),
    "fk_flash_bwd_dq": (_P,) * 9 + (_I,) * 6 + (_P, _I, _I, _I, _P),
    "fk_flash_bwd_resources": (_I, _I, _I, _P),
}
# its f32 twin (fk_attention_bwd_f32.cu): the same arguments without the
# dtype. fk_flash_bwd_f32_resources: kernel (0 dK / dV, 1 dQ), hd, 4 ints
# out.
ATTENTION_BWD_F32_SIGNATURES: dict[str, tuple] = {
    "fk_flash_bwd_f32_prep": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    "fk_flash_bwd_f32_dkdv": (_P,) * 10 + (_I,) * 6 + (_P, _I, _I, _P),
    "fk_flash_bwd_f32_dq": (_P,) * 9 + (_I,) * 6 + (_P, _I, _I, _P),
    "fk_flash_bwd_f32_resources": (_I, _I, _P),
}
SOURCES: dict[str, dict[str, tuple]] = {
    "fk_kernels": SIGNATURES,
    "fk_attention": ATTENTION_SIGNATURES,
    "fk_attention_bwd": ATTENTION_BWD_SIGNATURES,
    "fk_attention_bwd_f32": ATTENTION_BWD_F32_SIGNATURES,
    "fk_abft_gemm": ABFT_GEMM_SIGNATURES,
    "fk_update": UPDATE_SIGNATURES,
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded kernel library: the ctypes handle, where it came from, how
    long the build took (0 when an up-to-date build was reused) and what
    ``ptxas -v`` said about registers, shared memory and spills."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float
    ptxas_log: str


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


def _paths(name: str) -> tuple[Path, Path]:
    """(source, library) of ``name``; the library name hashes the source,
    the headers of ``csrc/`` and the flags."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _load(name: str, out: Path, seconds: float) -> KernelLibrary:
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SOURCES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.fk_error_string.argtypes = [ctypes.c_int]
    lib.fk_error_string.restype = ctypes.c_char_p
    log_path = out.with_suffix(".log")
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=out, build_seconds=seconds,
                         ptxas_log=log)


def build(*names: str) -> dict[str, KernelLibrary]:
    """Compile the named sources of ``SOURCES`` that have no up-to-date
    build, one nvcc process per source, all started at once; then load
    each with its argtypes set."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            src, out = _paths(name)
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                jobs[name] = (subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), tmp, out)
        seconds, errors = {}, []
        for name, (proc, tmp, out) in jobs.items():
            stdout, stderr = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed for {name}.cu (exit "
                              f"{proc.returncode}):\n{stderr}")
                continue
            out.with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, out)
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _load(name, _paths(name)[1], seconds.get(name, 0.0))
            for name in names}


_LIBS: dict[str, KernelLibrary] = {}
_LIBS_LOCK = threading.Lock()


def build_all() -> dict[str, KernelLibrary]:
    """Every source's library, the missing ones built in parallel."""
    with _LIBS_LOCK:
        missing = [n for n in SOURCES if n not in _LIBS]
        if missing:
            _LIBS.update(build(*missing))
        return dict(_LIBS)


def library(name: str = "fk_kernels") -> KernelLibrary:
    """The process's library of one source, built at first use."""
    with _LIBS_LOCK:
        if name not in _LIBS:
            _LIBS.update(build(name))
        return _LIBS[name]


def check(code: int, what: str, source: str = "fk_kernels") -> None:
    """Raise if a C entry point of ``source`` reported a CUDA error for its
    launch."""
    if code != 0:
        msg = library(source).lib.fk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


# --- launch helpers shared by the kernel wrappers --------------------------

def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the wrappers then take their
    plain version); False when all lie on one CUDA device. Anything else
    raises: a wrapper never moves data between devices or falls back."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise RuntimeError(f"kernel inputs must all lie on the CPU or on one CUDA "
                       f"device, got {sorted(str(t.device) for t in tensors)}")


def ptr(t, dtype, what: str, *, vec16: bool = False) -> int:
    """Device pointer of a contiguous CUDA tensor of ``dtype``; a 2-byte
    tensor, and any tensor with ``vec16`` (the f32 tile kernel's X, C and
    norms), must also be 16-byte aligned (the kernels stage it 16 bytes at
    a time)."""
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor, got "
                         f"{t.dtype} (contiguous={t.is_contiguous()})")
    if (vec16 or t.element_size() == 2) and t.data_ptr() % 16:
        raise ValueError(f"{what} ({t.dtype}) must start on a 16-byte "
                         f"boundary, got address {t.data_ptr():#x}")
    return t.data_ptr()


def input_dtype(*tensors):
    """The one input dtype of a tile kernel's X and C: float32, bfloat16 or
    float16. Anything else, or a mix, raises."""
    import torch
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16,
                                          torch.float16}:
        raise ValueError(f"X and C must share one dtype of float32, bfloat16 "
                         f"or float16, got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def launch(name: str, dtype, *args) -> int:
    """Call C entry point ``name`` for ``dtype``: the f32 kernel as it is,
    a 2-byte dtype through ``name + "_lp"`` (``name`` in
    :data:`LOWP_ENTRIES`) with its dtype code inserted before the last
    argument (the stream)."""
    lib = library().lib
    code = HALF_KINDS.get(str(dtype).replace("torch.", ""))
    if code is None:
        return getattr(lib, name)(*args)
    return getattr(lib, f"{name}_lp")(*args[:-1], code, args[-1])


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
