"""ABFT-protected GEMM (paper §IV applied to a plain product) on Hopper.

Replaces the Pallas TPU kernel ``matmul_abft`` of
``src/repro/kernels/matmul_abft.py`` (body ``_kernel``): D = X @ Y for X
(Mp, Kp) and Y (Kp, Np) of one dtype, f32, bf16 or fp16, into an f32 D,
with the dual-checksum invariant per output tile of ``block_m`` x
``block_n``. While the k loop runs, each tile accumulates its product and
the expected checksums

    col1 += (e1^T X_t) Y_t   col2 += (e2^T X_t) Y_t
    row1 += X_t (Y_t e1)     row2 += X_t (Y_t e2)     e1 = 1, e2 = 1..b

At the tile's last k-step the observed checksums of the tile are compared
with ``threshold_factor(Kp, dtype) * max(max|col1|, max|row1|, 1)`` (the
expected, clean side; the input dtype's rounding, as the reference's); a
fault is located by the e2/e1 ratio (the row residuals when the column
residual is degenerate) and one element corrected. An 8-word descriptor
(:func:`make_injection`, the distance kernel's format: m-tile, n-tile,
k-step of ``block_k``, row, col, delta) plants one fault after a k-step;
the kernel returns the detections per (m-tile, n-tile).

CUDA kernels, two in ``csrc/fk_abft_gemm.cu`` at every dtype:
``abft_encode_kernel<T>`` (:func:`abft_encodings`, plain version
:func:`abft_operands_plain`) computes the encodings once per call, E_X =
(e1^T X_t, e2^T X_t) per m-tile and E_Y = (Y_t e1, Y_t e2) per n-tile, in
f32 (2-byte values widened exactly); ``abft_gemm_kernel<T>`` is
persistent (a block an SM walking jobs of two m-tiles, one a consumer
warpgroup, by one n-tile, in 128 x 128 sub-tiles): a producer warpgroup
TMA-loads k-stages of X (K-major) and Y (MN-major, read as it lies) into
an ``mbarrier`` ring and the consumers run the product on ``wgmma`` with
f32 accumulators in registers. At bf16 / fp16, under each stage's
asynchronous MMA, the column checksums E_X Y_stage run on the CUDA cores,
and the row checksums X E_Y on the tensor cores (E_Y split into three
2-byte parts a value, :func:`split_encodings`, an 8-column operand beside
Y). At f32 the product is an f32-exact split on the bf16 tensor cores:
each value is hi + mid + lo in bf16 (:func:`split3_plain`), the pre-pass
writes Y's three planes (:func:`y_planes_plain`), each consumer thread
splits its f32 X fragment in registers, and D accumulates the six
products with i + j <= 2 (:func:`matmul_split_plain` emulates them); the
dropped ones are at most 2^-23 |x||y|, under f32's own rounding. Each
stage's products go into a fresh partial added to the accumulator on the
CUDA cores (the tensor cores' own accumulation is not rounded to
nearest). There the expected checksums come from the pre-pass
(``abft_colsum_kernel`` and ``abft_rowsum_kernel``,
:func:`column_checksums_plain`, :func:`row_checksums_plain`), which keeps
their registers and FMAs out of the product's loop. The
observed checksums are reduced from the accumulator registers, a tile is
decoded only when its residual is over its threshold, and the located
element is corrected in registers before D goes out by TMA stores (a
tile of several sub-tiles, bm > 128 or bn > 128, keeps its checksum state
in a workspace and patches the one element after its sub-tiles are
stored). Rows past a tile under 128 rows are masked out of every sum and
never stored. The fault lands after the stage that ends its k-step (64
deep at 2 bytes, 32 at f32).

Every sum has a fixed order, so a launch repeats bit for bit. Detections
are written per tile (no atomics) and summed per m-tile by the wrapper.

Bound on the H100: at bf16 / fp16, 2 * M * N * K FLOPs on the tensor
cores (989 TFLOP/s) or, for a short K, the bytes of the f32 D (3.35 TB/s);
at f32 six such products (a full-f32 product on the CUDA cores, 67
TFLOP/s, takes 2.5 times as long). The checksums add, per tile, 2 bn K
FMAs on the CUDA cores (overlapped with the product) and 8 bm K MACs on
the tensor cores, and one read of X and Y for the encodings; at f32 the
pre-pass's checksums instead, 4 (Mp/bm) K Np + 4 Mp K (Np/bn) FLOPs on the
CUDA cores (X and Y read once more), and a write of Y's planes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.kernels.distance_argmin_ft import (  # noqa: F401 (re-export)
    INJ_LEN, abft_correct_plain, make_injection, no_injection)


# k of the 2-byte kernel's ring stages: its encodings run to Kp rounded up
# to this, zero past Kp
ENC_K_ALIGN: int = 64
# the C entry points' dtype codes
GEMM_KINDS = {"bfloat16": 0, "float16": 1, "float32": 2}
# bf16's largest finite value, (2 - 2^-7) 2^127: the split's hi saturates
# here
BF16_MAX: float = float.fromhex("0x1.fep+127")


def _enc_k(kp: int) -> int:
    return -(-kp // ENC_K_ALIGN) * ENC_K_ALIGN


def check_tiles(x: torch.Tensor, y: torch.Tensor, block_m: int,
                block_n: int, block_k: int) -> None:
    """Raise unless x (Mp, Kp) and y (Kp, Np) are padded to the tiles."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0] \
            or x.shape[0] % block_m or y.shape[1] % block_n \
            or x.shape[1] % block_k:
        raise ValueError(f"unpadded shapes x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)} vs tiles "
                         f"{(block_m, block_n, block_k)}")


def check_cuda_tiles(block_m: int, block_n: int, block_k: int) -> None:
    """Raise for a tile the CUDA kernel is not built for."""
    if (block_m < 8 or block_m % 8 or (block_m > 128 and block_m % 128)
            or block_m > 1024 or block_n < 128 or block_n % 128
            or block_n > 1024 or block_k < 32 or block_k % 32):
        raise ValueError(
            f"({block_m}, {block_n}, {block_k}) is not a tile of the CUDA "
            f"ABFT GEMM: rows a multiple of 8 up to 128 or of 128 up to 1024, "
            f"columns a multiple of 128 up to 1024, k a multiple of 32")


def encoding_scales(block_n: int) -> tuple[int, int]:
    """The powers of two (e1, e2) the split E_Y is scaled down by:
    ceil(log2 bn) and ceil(log2 (bn (bn + 1) / 2)), the most |e1| and |e2|
    can exceed max |y| by, so fp16 parts never overflow."""
    return ((block_n - 1).bit_length(),
            (block_n * (block_n + 1) // 2 - 1).bit_length())


def split_encodings(ey: torch.Tensor, block_n: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """The split E_Y the GEMM's row checksums take on the tensor cores:
    for E_Y (Np/bn, Kpe, 2), a (Np/bn, 8, Kpe) tensor of ``dtype`` whose
    rows 0-2 are e1 2^-s1 as hi + mid + lo (each rounded to nearest from
    what the earlier parts leave), rows 3-5 e2 2^-s2 the same, rows 6-7
    zero (:func:`encoding_scales`)."""
    s1, s2 = encoding_scales(block_n)
    scaled = torch.stack((ey[..., 0] * 2.0 ** -s1,
                          ey[..., 1] * 2.0 ** -s2), 1)         # exact
    parts = []
    rest = scaled
    for _ in range(3):
        part = rest.to(dtype)
        parts.append(part)
        rest = rest - part.float()
    split = torch.stack(parts, 2).flatten(1, 2)            # (nt, 6, Kpe)
    return F.pad(split, (0, 0, 0, 2)).contiguous()


def split3_plain(x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 kernel's operand split: x (f32) as three bf16 tensors hi =
    bf16(x) (saturated at :data:`BF16_MAX`), mid = bf16(x - hi), lo =
    bf16(x - hi - mid), each rounded to nearest, the differences exact in
    f32. hi + mid + lo == x exactly for every finite x of magnitude 2^-110
    or more, and for 0 (each part takes the next 8 bits; bf16 has f32's
    exponent range); below, the parts fall under bf16's subnormal spacing
    and the sum is off by at most 2^-134. +-inf splits as (+-max, +-inf,
    NaN) and NaN as (-max, NaN, NaN): the parts of a non-finite value sum
    to NaN."""
    x = x.float()
    top = torch.tensor(BF16_MAX, dtype=torch.float32, device=x.device)
    hi = torch.fmin(torch.fmax(x, -top), top).to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def y_planes_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain version of the Y operand the f32 pre-pass writes: y (Kp, Np)
    f32 as its three bf16 planes (3, Kp, Np), hi, mid, lo
    (:func:`split3_plain`)."""
    return torch.stack(split3_plain(y)).contiguous()


SPLIT_K_STEP = 16      # the f32 kernel's k-step: one wgmma m64n64k16 deep


def matmul_split_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain emulation of the f32 kernel's product: x (M, K) and y (K, N)
    split three ways (:func:`split3_plain`), D the f32 sum of the six
    products with i + j <= 2 (hi hi, hi mid, mid hi, hi lo, mid mid, lo
    hi), each an f32 product of exactly widened parts. The dropped ones
    (mid lo, lo mid, lo lo) are at most 2^-23 |x||y| together.

    In the kernel's order of adds: each 16-deep k-step's six products, in
    that order, into a fresh f32 partial, the partial then added to D. (The
    tensor cores' own order within one 16-deep product is not IEEE; an f32
    sum of its 16 terms stands for it.)"""
    ref.full_f32(x.device)
    xs = [p.float() for p in split3_plain(x)]
    ys = [p.float() for p in split3_plain(y)]
    d = torch.zeros(x.shape[0], y.shape[1], dtype=torch.float32,
                    device=x.device)
    for k0 in range(0, x.shape[1], SPLIT_K_STEP):
        ks = slice(k0, k0 + SPLIT_K_STEP)
        part = None
        for i, j in ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)):
            prod = xs[i][:, ks] @ ys[j][ks]
            part = prod if part is None else part + prod
        d = d + part
    return d


def abft_encodings_plain(x: torch.Tensor, y: torch.Tensor, block_m: int,
                         block_n: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the 2-byte kernel's encodings of x (Mp, Kp)
    and y (Kp, Np), in f32 from the widened values: E_X (Mp/bm, Kpe, 2),
    E_X[mt, k] = (sum_r X[mt bm + r, k], sum_r (r + 1) X[mt bm + r, k]),
    and E_Y (Np/bn, Kpe, 2), E_Y[nt, k] = (sum_c Y[k, nt bn + c], sum_c
    (c + 1) Y[k, nt bn + c]), r and c within the tile; Kpe = Kp rounded up
    to :data:`ENC_K_ALIGN`, zeros past Kp; and E_Y split
    (:func:`split_encodings`) in x's dtype."""
    ref.full_f32(x.device)
    mp, kp = x.shape
    np_ = y.shape[1]
    dev = x.device
    xv = x.float().view(mp // block_m, block_m, kp)
    yv = y.float().view(kp, np_ // block_n, block_n)
    w_m = torch.arange(1, block_m + 1, dtype=torch.float32, device=dev)
    w_n = torch.arange(1, block_n + 1, dtype=torch.float32, device=dev)
    ex = torch.stack((xv.sum(1), (w_m[None, :, None] * xv).sum(1)), -1)
    ey = torch.stack((yv.sum(2), (yv * w_n).sum(2)), -1).permute(1, 0, 2)
    pad = (0, 0, 0, _enc_k(kp) - kp)
    ey = F.pad(ey, pad).contiguous()
    return (F.pad(ex, pad).contiguous(), ey,
            split_encodings(ey, block_n, x.dtype))


def column_checksums_plain(ex: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32 pre-pass's expected column checksums: for
    E_X (Mp/bm, Kpe, 2) and y (Kp, Np) f32, (Mp/bm, Np, 2) with [mt, n] =
    (sum_k E_X[mt, k, 0] y[k, n], sum_k E_X[mt, k, 1] y[k, n]), col1 and
    col2 of every tile of m-tile mt."""
    ref.full_f32(y.device)
    return torch.einsum("mke,kn->mne", ex[:, :y.shape[0]],
                        y.float()).contiguous()


def row_checksums_plain(x: torch.Tensor, ey: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32 pre-pass's expected row checksums: for x
    (Mp, Kp) f32 and E_Y (Np/bn, Kpe, 2), (Np/bn, Mp, 2) with [nt, m] =
    (sum_k x[m, k] E_Y[nt, k, 0], sum_k x[m, k] E_Y[nt, k, 1]), row1 and
    row2 of every tile of n-tile nt."""
    ref.full_f32(x.device)
    return torch.einsum("mk,nke->nme", x.float(),
                        ey[:, :x.shape[1]]).contiguous()


def abft_operands_plain(x: torch.Tensor, y: torch.Tensor, block_m: int,
                        block_n: int) -> tuple[torch.Tensor, ...]:
    """Plain version of the pre-pass's outputs for the GEMM: at bf16 /
    fp16 :func:`abft_encodings_plain` (E_X, E_Y, split E_Y); at f32 E_X,
    E_Y, Y's planes (:func:`y_planes_plain`), the B operands of the split
    product, and the expected column and row checksums
    (:func:`column_checksums_plain`, :func:`row_checksums_plain`)."""
    ex, ey, esy = abft_encodings_plain(x, y, block_m, block_n)
    if x.dtype == torch.float32:
        return (ex, ey, y_planes_plain(y), column_checksums_plain(ex, y),
                row_checksums_plain(x, ey))
    return ex, ey, esy


def _tma_ptr(t: torch.Tensor, dtype, what: str) -> int:
    """Device pointer of a contiguous ``dtype`` tensor the kernels read
    through TMA: it must start on a 16-byte boundary (at f32 too)."""
    p = _build.ptr(t, dtype, what)
    if p % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary, got "
                         f"address {p:#x}")
    return p


def abft_encodings(x: torch.Tensor, y: torch.Tensor, *, block_m: int,
                   block_n: int) -> tuple[torch.Tensor, ...]:
    """The ABFT GEMM's encodings pre-pass (``abft_encode_kernel``, at f32
    then ``abft_colsum_kernel`` and ``abft_rowsum_kernel``) on pre-padded
    f32, bf16 or fp16 x, y; its plain version on the CPU. Returns
    :func:`abft_operands_plain`'s (E_X, E_Y, split E_Y) at 2 bytes, (E_X,
    E_Y, Y's bf16 planes, the expected column and row checksums) at
    f32."""
    check_tiles(x, y, block_m, block_n, 32)
    dt = _build.input_dtype(x, y)
    if _build.on_cpu(x, y):
        return abft_operands_plain(x, y, block_m, block_n)
    code = GEMM_KINDS[str(dt).replace("torch.", "")]
    check_cuda_tiles(block_m, block_n, 32)
    mp, kp = x.shape
    np_ = y.shape[1]
    kpe = _enc_k(kp)
    ex = torch.empty((mp // block_m, kpe, 2), dtype=torch.float32,
                     device=x.device)
    ey = torch.empty((np_ // block_n, kpe, 2), dtype=torch.float32,
                     device=x.device)
    f32 = dt == torch.float32
    if f32:
        esy = torch.empty((3, kp, np_), dtype=torch.bfloat16,
                          device=x.device)
        ecol = torch.empty((mp // block_m, np_, 2), dtype=torch.float32,
                           device=x.device)
        erow = torch.empty((np_ // block_n, mp, 2), dtype=torch.float32,
                           device=x.device)
    else:
        esy = torch.empty((np_ // block_n, 8, kpe), dtype=dt,
                          device=x.device)
    err = _build.library("fk_abft_gemm").lib.fk_abft_encode(
        _tma_ptr(x, dt, "x"), _tma_ptr(y, dt, "y"), ex.data_ptr(),
        ey.data_ptr(), esy.data_ptr(), ecol.data_ptr() if f32 else 0,
        erow.data_ptr() if f32 else 0, mp, np_, kp, block_m, block_n, code,
        _build.stream_of(x))
    _build.check(err, "abft_encodings", "fk_abft_gemm")
    abft_encodings.launches += 1
    return (ex, ey, esy, ecol, erow) if f32 else (ex, ey, esy)


abft_encodings.launches = 0


def matmul_abft_plain(x: torch.Tensor, y: torch.Tensor, inj: torch.Tensor,
                      block_m: int, block_n: int, block_k: int,
                      factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the full-f32 product (2-byte X and Y
    widened first, so every term is exact, as on the tensor cores), then
    the kernel's per-tile detection and correction (``abft_correct_plain``,
    the plain ABFT of the distance kernel, with Y^T in the centroids'
    place). The fault is added to the finished product, not after k-step
    ``k_step``. Returns (D (Mp, Np) f32, det (Mp/bm,) int32)."""
    ref.full_f32(x.device)
    xf, yf = x.float(), y.float()
    return abft_correct_plain(xf @ yf, xf, yf.T.contiguous(), inj, block_m,
                              block_n, block_k, factor)


def _gemm_workspace(dev: torch.device, block_m: int,
                    block_n: int) -> torch.Tensor:
    """The kernel's scratch for the checksum state of tiles larger
    than its 128 x 128 sub-tile: 2 x 6 x 1024 floats a block, a block an
    SM; empty for smaller tiles (their state stays in shared memory)."""
    if block_m <= 128 and block_n <= 128:
        return torch.empty(0, dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty(sms * 2 * 6 * 1024, dtype=torch.float32, device=dev)


def matmul_abft(x: torch.Tensor, y: torch.Tensor, inj: torch.Tensor, *,
                block_m: int, block_n: int, block_k: int, factor: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw ABFT GEMM entry on pre-padded inputs of one dtype (f32, bf16 or
    fp16); ``inj`` is an int32 descriptor on the data's device and
    ``factor`` the static part of the threshold (``threshold_factor(Kp,
    dtype)``). Returns (D (Mp, Np) f32, det (Mp/bm,) int32)."""
    check_tiles(x, y, block_m, block_n, block_k)
    dt = _build.input_dtype(x, y)
    if inj.shape[0] < 7:
        raise ValueError(f"injection descriptor too short: {inj.shape}")
    if _build.on_cpu(x, y, inj):
        return matmul_abft_plain(x, y, inj, block_m, block_n, block_k,
                                 factor)
    check_cuda_tiles(block_m, block_n, block_k)
    mp, kp = x.shape
    np_ = y.shape[1]
    dev = x.device
    d = torch.empty((mp, np_), dtype=torch.float32, device=dev)
    det = torch.empty((mp // block_m, np_ // block_n), dtype=torch.int32,
                      device=dev)
    inj_p = _build.ptr(inj, torch.int32, "inj")
    kind = GEMM_KINDS[str(dt).replace("torch.", "")]
    ex, _, op, *checks = abft_encodings(x, y, block_m=block_m,
                                        block_n=block_n)
    # Y's operand and the kernel's encodings: at 2 bytes y, E_X and the
    # split E_Y (op); at f32 Y's planes (op) and the expected row and
    # column checksums
    if checks:
        yb, ea, eb = op, checks[1], checks[0]
    else:
        yb, ea, eb = y, ex, op
    ws = _gemm_workspace(dev, block_m, block_n)
    err = _build.library("fk_abft_gemm").lib.fk_abft_gemm(
        _tma_ptr(x, dt, "x"), _tma_ptr(yb, yb.dtype, "y"), inj_p,
        ea.data_ptr(), eb.data_ptr(), d.data_ptr(), det.data_ptr(),
        ws.data_ptr(), ws.numel(), factor, mp, np_, kp, block_m, block_n,
        block_k, kind, _build.stream_of(x))
    _build.check(err, "matmul_abft", "fk_abft_gemm")
    matmul_abft.launches += 1
    return d, det.sum(1, dtype=torch.int32)


matmul_abft.launches = 0
