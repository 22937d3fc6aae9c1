"""The attention gradient at head dim 256 and at f32, on the CPU.

On the card, ``csrc/fk_attention_bwd.cu`` takes hd 256 in bf16 / fp16 (row
11b-256: a dK / dV block of ``BWD_ROWS`` keys whose columns the two
warpgroups split in halves of ``BWD_HALF_HD``, S^T and dP^T over the whole
hd in each; a dQ walk of ``BWD_TILE_HD256``-key steps) and
``csrc/fk_attention_bwd_f32.cu`` takes f32 (row 11bf, the tiles of
``BWD_F32_TILES``); both reach the forward's row log-sum-exp. Here, where
no kernel runs, their plain version ``flash_attention_backward_plain`` is
held:

* through ``attend``'s kernel route (``_attend_kernel`` on CPU tensors,
  ``FlashAttentionFn``) to ``jax.vjp`` of the reference's ``_attend_local``
  at hd 256 with gemma3's window 1024, with recurrentgemma's one KV head
  and group 16 under a window of 2048, at whisper's non-causal
  cross-attention over 1500 frames, and at the SMOKE configs' hd 16;
* the hd-256 design's walk written in plain PyTorch (each column half on
  its own, the scores over all of hd) against the whole gradient;
* the tile constants against the sources, and the names ``chip_smoke.py``
  reads;
* the rows of dS summing to zero with D = rowsum(P o dP), the prep
  kernel's, over keys and values that share most of their direction, where
  D from the rounded output leaves dq off by more than itself.

Everything runs in f32, so the bar is f32 rounding through a few sums:
``RTOL`` x max|grad| per tensor (the bar of ``tests/test_torch_flash_bwd.py``).
Inputs are made from a seed with numpy.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

RTOL = 2e-5        # x max|grad|, f32 sums in other orders
CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"

# name: (b, h, kv, sq, skv, hd, causal, window, query holes, key holes)
CASES = {
    # gemma3-4b's local layers: hd 256, window 1024, group 2
    "hd256_window1024": (1, 4, 2, 1100, 1100, 256, True, 1024, (), ()),
    # recurrentgemma-9b's attention: one KV head, group 16, window 2048
    "g16_window2048": (1, 16, 1, 2100, 2100, 16, True, 2048, (), (9,)),
    # whisper-medium's cross-attention: every one of 1500 frames visible
    "noncausal_skv1500": (1, 4, 4, 24, 1500, 64, False, 0, (), ()),
    # the SMOKE configs' hd 16 (the card pads it to 64), with holes
    "hd16_holes": (2, 4, 2, 40, 40, 16, True, 0, (3,), (10, 11)),
    # hd 256 with key and query holes, ragged, a short window
    "hd256_ragged": (1, 2, 1, 37, 70, 256, True, 20, (4,), (30, 31)),
}


def _inputs(case, seed=0):
    b, h, kv, sq, skv, hd, causal, window, qholes, kholes = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(size=(b, kv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv, skv, hd)).astype(np.float32)
    do = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    qpos = np.arange(skv - sq, skv, dtype=np.int32)
    kpos = np.arange(skv, dtype=np.int32)
    if not causal:
        qpos[:] = 0                   # cross-attention's query positions
    qpos[list(qholes)] = -7
    kpos[list(kholes)] = -1
    return q, k, v, do, qpos, kpos, causal, window


def _close(got, want, what):
    for name, g, w in zip("qkv", got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        bar = RTOL * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= bar, f"{what} d{name}: {err} > {bar}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_route_grads_match_reference_vjp(case):
    """``attend``'s kernel route (the hd ** -0.5 scaling, then
    ``flash_attention`` through ``FlashAttentionFn``, whose backward is
    ``flash_attention_backward_plain`` on CPU tensors) against ``jax.vjp``
    of the reference's chunked attention."""
    q, k, v, do, qpos, kpos, causal, window = _inputs(case)
    hd = q.shape[-1]
    qs, ks, vs, dos = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                       for a in (q * hd ** 0.5, k, v, do))

    def ref(q_, k_, v_):
        return j_attn._attend_local(
            q_, k_, v_, q_positions=jnp.asarray(qpos),
            kv_positions=jnp.asarray(kpos), causal=causal, window=window,
            chunk=512)
    out, vjp = jax.vjp(ref, jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs))
    want = vjp(jnp.asarray(dos))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (qs, ks, vs))
    got_out = t_attn._attend_kernel(qt, kt, vt,
                                    q_positions=torch.from_numpy(qpos),
                                    kv_positions=torch.from_numpy(kpos),
                                    causal=causal, window=window)
    assert type(got_out.grad_fn.next_functions[0][0]).__name__ \
        == "FlashAttentionFnBackward"
    got = torch.autograd.grad(got_out, (qt, kt, vt), torch.from_numpy(dos))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    _close([g.numpy() for g in got], [np.asarray(w) for w in want], case)


def _walk_hd256(q, k, v, out, do, lse, qpos, kpos, causal, window):
    """The hd-256 kernels' walks in plain PyTorch, f32: dK / dV blocks of
    ``BWD_ROWS`` keys, each of the two column halves accumulated on its own
    from P^T and dS^T taken over all of hd, the query tiles of ``BWD_TILE``
    rows over the group's heads; dQ blocks of ``BWD_BLOCK`` rows over steps
    of ``BWD_TILE_HD256`` keys. Tiles that ``live_tiles`` calls DEAD are
    skipped, FULL ones not masked."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    mask = fa.position_mask(qpos, kpos, causal, window).expand(sq, skv)
    dsum = (do * out).sum(-1)
    kb_, qt_, tk = fa.BWD_ROWS, fa.BWD_TILE, fa.BWD_TILE_HD256
    half = fa.BWD_HALF_HD
    cls_kv = fa.live_tiles(qpos, kpos, qt_, kb_, causal, window)
    cls_q = fa.live_tiles(qpos, kpos, fa.BWD_ROWS, tk, causal, window)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def step(hh, bi, kh, qs, ks, c):
        s = q[bi, hh, qs] @ k[bi, kh, ks].T
        p = torch.exp(s - lse[bi, hh, qs, None])
        if c == fa.LIVE:
            p = torch.where(mask[qs, ks], p, 0.0)
        dp = do[bi, hh, qs] @ v[bi, kh, ks].T
        return p, p * (dp - dsum[bi, hh, qs, None])
    for bi in range(b):
        for kh in range(kvh):
            for kb in range(-(-skv // kb_)):
                ks = slice(kb * kb_, (kb + 1) * kb_)
                for cols in (slice(0, half), slice(half, hd)):
                    for qt in range(-(-sq // qt_)):
                        c = cls_kv[qt, kb]
                        if c == fa.DEAD:
                            continue
                        qs = slice(qt * qt_, (qt + 1) * qt_)
                        for j in range(g):
                            hh = kh * g + j
                            p, ds = step(hh, bi, kh, qs, ks, c)
                            dv[bi, kh, ks, cols] += p.T @ do[bi, hh, qs, cols]
                            dk[bi, kh, ks, cols] += ds.T @ q[bi, hh, qs, cols]
        for hh in range(h):
            kh = hh // g
            for qw in range(-(-sq // fa.BWD_ROWS)):
                qs = slice(qw * fa.BWD_ROWS, (qw + 1) * fa.BWD_ROWS)
                for t in range(-(-skv // tk)):
                    c = cls_q[qw, t]
                    if c == fa.DEAD:
                        continue
                    ks = slice(t * tk, (t + 1) * tk)
                    _, ds = step(hh, bi, kh, qs, ks, c)
                    dq[bi, hh, qs] += ds @ k[bi, kh, ks]
    return dq, dk, dv


@pytest.mark.parametrize("seed", range(3))
def test_hd256_walk_half_by_half_is_the_whole(seed):
    """dK and dV accumulated one column half at a time, each half's P and
    dS from scores over all of hd (what each consumer warpgroup of the
    hd-256 dK / dV kernel computes), give the whole gradient; so do the dQ
    kernel's 32-key steps."""
    rng = np.random.default_rng(seed)
    b, kv, g, hd = 1, 2, int(rng.choice([1, 2, 4])), 256
    sq, skv = int(rng.integers(40, 200)), int(rng.integers(40, 260))
    window = int(rng.choice([0, 30, 100]))
    causal = bool(seed != 1)
    kpos = np.arange(skv, dtype=np.int32)
    kpos[rng.random(skv) < 0.05] = -1
    qpos = np.sort(rng.integers(-5, skv + 5, size=sq)).astype(np.int32)
    qpos[rng.random(sq) < 0.05] = -7
    q, do = (torch.from_numpy(rng.normal(size=(b, kv * g, sq, hd))
                              .astype(np.float32)) for _ in range(2))
    q = q * hd ** -0.5
    k, v = (torch.from_numpy(rng.normal(size=(b, kv, skv, hd))
                             .astype(np.float32)) for _ in range(2))
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    out = fa.flash_attention_plain(q, k, v, qp, kp, causal=causal,
                                   window=window, zero_empty_rows=True)
    lse = fa.flash_lse_plain(q, k, qp, kp, causal=causal, window=window)
    got = _walk_hd256(q, k, v, out, do, lse, qp, kp, causal, window)
    want = fa.flash_attention_backward_plain(q, k, v, out, do, lse, qp, kp,
                                             causal=causal, window=window)
    for name, a, w in zip("qkv", got, want):
        bar = RTOL * max(float(w.abs().max()), 1e-30)
        assert float((a - w).abs().max()) <= bar, f"d{name}"


def test_f64_plain_backward_is_computed_in_f64():
    """The f32 kernels' floor reads the plain backward in f64: f64 inputs
    stay f64 through it (and f32 ones f32)."""
    q, k, v, do, qpos, kpos, causal, window = _inputs("hd16_holes")
    t = [torch.from_numpy(a).double() for a in (q, k, v, do)]
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    out = fa.flash_attention_plain(t[0], t[1], t[2], qp, kp,
                                   zero_empty_rows=True)
    lse = fa.flash_lse_plain(t[0], t[1], qp, kp).double()
    got64 = fa.flash_attention_backward_plain(t[0], t[1], t[2], out.double(),
                                              t[3], lse, qp, kp)
    got32 = fa.flash_attention_backward_plain(
        *(x.float() for x in (t[0], t[1], t[2], out, t[3])), lse.float(), qp,
        kp)
    assert all(g.dtype == torch.float64 for g in got64)
    assert all(g.dtype == torch.float32 for g in got32)
    for a, b in zip(got32, got64):
        err = float((a.double() - b).abs().max())
        assert 0 < err <= 1e-5 * float(b.abs().max())


def test_tiles_are_the_sources():
    bwd = (CSRC / "fk_attention_bwd.cu").read_text()
    assert re.search(r"constexpr int tile = HD > 128 \? (\d+) : kTile;",
                     bwd)[1] == str(fa.BWD_TILE_HD256)
    assert "static constexpr int block = split ? kRows : kBlock;" in bwd
    assert "static constexpr int cols = split ? HD / 2 : HD;" in bwd
    assert fa.BWD_HALF_HD == 256 // 2
    f32 = (CSRC / "fk_attention_bwd_f32.cu").read_text()
    rg = re.search(r"int RG = HD <= 128 \? (\d) : (\d);", f32)
    bt = re.search(r"int BT = HD <= 64 \? (\d+) : (\d+);", f32)
    for hd, (rows, step) in fa.BWD_F32_TILES.items():
        want_rg = int(rg[1] if hd <= 128 else rg[2])
        assert rows == 8 * 4 * want_rg                # 8 warps x 4 RG rows
        assert step == int(bt[1] if hd <= 64 else bt[2])


def test_names_chip_smoke_reads():
    for name in ("flash_bwd_f32_prep", "flash_bwd_f32_dkdv",
                 "flash_bwd_f32_dq"):
        assert getattr(fa, name).launches == 0
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        assert isinstance(getattr(fa, name).launches_hd256, int)
    assert set(_build.SOURCES["fk_attention_bwd_f32"]) == {
        "fk_flash_bwd_f32_prep", "fk_flash_bwd_f32_dkdv",
        "fk_flash_bwd_f32_dq", "fk_flash_bwd_f32_resources"}
    text = (CSRC / "fk_attention_bwd_f32.cu").read_text()
    for kernel in ("flash_bwd_f32_prep_kernel", "flash_bwd_f32_dkdv_kernel",
                   "flash_bwd_f32_dq_kernel"):
        assert f"\n{kernel}(" in text
    assert fa.GRAD_MAX_HEAD_DIM == 256


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_check_grad_takes_every_dtype_and_head_dim(dtype, hd):
    """``_check_grad`` lets every dtype and head dim of the forward through
    with ``zero_empty_rows=True``: the card runs the hand-written backward
    kernels there, never a fallback."""
    q = torch.zeros((1, 2, 4, hd), dtype=getattr(torch, dtype))
    fa._check_grad(q, hd, True)
    with pytest.raises(fa.FlashGradUnsupported):
        fa._check_grad(q, hd, False)


@pytest.mark.parametrize("spread", [1e-1, 1e-2])
def test_ds_rows_sum_to_zero_over_shared_directions(spread):
    """Keys and values that share most of their direction (a deep random
    model's tokens and frames: whisper-medium's on the card) make dq = dS K
    a sum that cancels to a small remainder, which holds only while each
    row of dS sums to zero. D = rowsum(P o dP) (``flash_bwd_prep_plain``,
    the prep kernel's) keeps the row sums at f32's rounding; D from the
    rounded output, dO . O, leaves them at dO . (O - P V), O's rounding
    times the shared value, and dq off by more than itself. Read against
    the plain backward in f64; keys and values N(c, spread^2), |c| ~ 8."""
    rng = np.random.default_rng(3)
    b, h, sq, skv, hd = 1, 4, 64, 1500, 64
    ck, cv = rng.normal(size=(hd,)), rng.normal(size=(hd,))

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    q = bf16(0.125 * rng.normal(size=(b, h, sq, hd)))
    do = bf16(rng.normal(size=(b, h, sq, hd)))
    k = bf16(ck + spread * rng.normal(size=(b, h, skv, hd)))
    v = bf16(cv + spread * rng.normal(size=(b, h, skv, hd)))
    qp = torch.zeros(sq, dtype=torch.int32)
    kp = torch.arange(skv, dtype=torch.int32)
    out = fa.flash_attention_plain(q, k, v, qp, kp, causal=False,
                                   zero_empty_rows=True)
    lse = fa.flash_lse_plain(q, k, qp, kp, causal=False)
    f = [t.float() for t in (q, k, v, out, do)]
    exact = fa.flash_attention_backward_plain(
        *(t.double() for t in f), lse.double(), qp, kp, causal=False)
    got = fa.flash_attention_backward_plain(*f, lse, qp, kp, causal=False)
    qf, kf, vf, of, dof = f
    p = torch.exp(qf @ kf.transpose(-1, -2) - lse[..., None])
    dp = dof @ vf.transpose(-1, -2)
    d_new = fa.flash_bwd_prep_plain(q, k, v, do, lse, qp, kp,
                                    causal=False)[..., None]
    d_out = (dof * of).sum(-1, keepdim=True)
    scale = (p * (dp - d_new)).abs().sum(-1)
    rows = {n: float(((p * (dp - d)).sum(-1).abs() / scale).max())
            for n, d in (("prep", d_new), ("output", d_out))}
    assert rows["prep"] < 2.0 ** -12, rows
    assert rows["output"] > 100 * rows["prep"], rows

    def rel(a, w):
        return float((a.double() - w).norm() / w.norm())
    dq_out = (p * (dp - d_out)) @ kf
    assert rel(got[0], exact[0]) < 2.0 ** -5
    assert rel(dq_out, exact[0]) > 100 * rel(got[0], exact[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prep_plain_is_do_dot_pv(dtype):
    """``flash_bwd_prep_plain``, the 2-byte prep kernel's plain version: D =
    rowsum(P o dP) = dO . (P V), P from lse, in f32; zero for a row with no
    valid key. At f32 it is the f32 kernels' dO . O up to f32 rounding;
    held against dO . (P V) in f64 with a window and a query hole."""
    rng = np.random.default_rng(11)
    b, h, kv, s, hd = 2, 4, 2, 50, 16
    dt = getattr(torch, dtype)
    q, do = (torch.from_numpy(rng.normal(size=(b, h, s, hd)).astype(
        np.float32)).to(dt) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, kv, s, hd)).astype(
        np.float32)).to(dt) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32)
    qpos = pos.clone()
    qpos[7] = -3                                   # a row with no key
    lse = fa.flash_lse_plain(q, k, qpos, pos, window=9)
    got = fa.flash_bwd_prep_plain(q, k, v, do, lse, qpos, pos, window=9)
    mask = fa.position_mask(qpos, pos, True, 9)
    kk, vv = (t.double().repeat_interleave(h // kv, dim=1) for t in (k, v))
    sc = torch.where(mask, q.double() @ kk.transpose(-1, -2),
                     torch.tensor(-np.inf, dtype=torch.float64))
    pv = torch.softmax(sc, -1).nan_to_num(0.0) @ vv
    want = (do.double() * pv).sum(-1)
    scale = float((do.double().abs() * pv.abs()).sum(-1).max())
    assert float((got.double() - want).abs().max()) <= 1e-5 * scale
    assert torch.all(got[:, :, 7] == 0)
    if dtype == "float32":
        out = fa.flash_attention_plain(q, k, v, qpos, pos, window=9,
                                       zero_empty_rows=True)
        assert float((got - (do * out).sum(-1)).abs().max()) <= 1e-5 * scale
