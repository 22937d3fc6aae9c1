"""The flash kernels' plain versions on a context-parallel query shard, on
the CPU.

On a mesh with a ``model`` axis of tp ranks, ``attend`` gives rank r the
queries r * S / tp .. (r + 1) * S / tp - 1 against all S keys (Sq < Skv,
the query block at an offset), and sums k's and v's gradients over the
ranks (``repro_torch.models.attention``). Here, for every shard of a
4-way split, causal and windowed, at GQA groups 1 and 2:

  * ``flash_attention_backward_plain`` (the plain version of
    ``csrc/fk_attention_bwd.cu``) against autograd of
    ``flash_attention_plain`` on the shard, and ``attend``'s kernel route
    (``FlashAttentionFn`` on CPU tensors) against ``jax.vjp`` of the
    reference's ``_attend_local`` on the shard;
  * the shards put back together: the outputs and dQ rows are the whole
    sequence's, and dK / dV summed over the shards are its dK / dV;
  * ``live_tiles`` at the tile sizes the forward and backward kernels
    classify at: sound on the shard (a DEAD pair holds no valid pair, a
    FULL one only valid pairs), and under causal masking the last shard
    meets the most live tiles.

f32 throughout: ``RTOL`` x max|grad| per tensor, as
``tests/test_torch_flash_bwd.py``. Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

RTOL = 2e-5        # x max|grad|, f32 sums in other orders
TP = 4
# name: (b, h, kv, S, hd, causal, window)
CASES = {"causal_g2": (1, 4, 2, 96, 16, True, 0),
         "causal_g1": (2, 2, 2, 64, 8, True, 0),
         "window_g2": (1, 4, 2, 96, 16, True, 20)}
# (query rows, keys) the kernels classify tiles at: the prefill kernel's
# blocks, the backward's producer steps (dK / dV, dQ) and warpgroup steps
TILE_SIZES = [(hw.FLASH_BLOCK_Q, hw.FLASH_BLOCK_K),
              (fa.BWD_TILE, fa.BWD_BLOCK), (fa.BWD_BLOCK, fa.BWD_TILE),
              (fa.BWD_TILE, fa.BWD_ROWS), (fa.BWD_ROWS, fa.BWD_TILE)]


def _inputs(case, seed=0):
    b, h, kv, s, hd, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    do = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    return q, k, v, do, causal, window


def _shard(r, s):
    n = s // TP
    return slice(r * n, (r + 1) * n)


def _close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        bar = RTOL * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= bar, f"{what} {name}: {err} > {bar}"


def _shard_backward(q, k, v, do, r, causal, window):
    """(out, lse, (dq, dk, dv)) of shard r by the plain versions."""
    s = k.shape[2]
    rows = _shard(r, s)
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (q[:, :, rows], k, v))
    dot = torch.from_numpy(np.ascontiguousarray(do[:, :, rows]))
    qp = torch.arange(s, dtype=torch.int32)[rows]
    kp = torch.arange(s, dtype=torch.int32)
    out = fa.flash_attention_plain(qt, kt, vt, qp, kp, causal=causal,
                                   window=window)
    lse = fa.flash_lse_plain(qt, kt, qp, kp, causal=causal, window=window)
    grads = fa.flash_attention_backward_plain(
        qt, kt, vt, out, dot, lse, qp, kp, causal=causal, window=window)
    return out, lse, grads


@pytest.mark.parametrize("r", range(TP))
@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_backward_matches_autograd(case, r):
    q, k, v, do, causal, window = _inputs(case)
    s = k.shape[2]
    rows = _shard(r, s)
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(a))
                  .requires_grad_(True) for a in (q[:, :, rows], k, v))
    qp = torch.arange(s, dtype=torch.int32)[rows]
    kp = torch.arange(s, dtype=torch.int32)
    assert int(qp[0]) == r * s // TP
    out = fa.flash_attention_plain(qt, kt, vt, qp, kp, causal=causal,
                                   window=window)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(
        np.ascontiguousarray(do[:, :, rows])))
    _, _, got = _shard_backward(q, k, v, do, r, causal, window)
    _close([g.numpy() for g in got], [w.numpy() for w in want],
           f"{case} shard {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_shards_sum_to_the_whole_sequence(case):
    """Each shard's output and dQ rows are the whole sequence's; dK and dV
    summed over the shards (the mesh's partial sums over ``model``) are
    the whole sequence's."""
    q, k, v, do, causal, window = _inputs(case)
    s = k.shape[2]
    pos = torch.arange(s, dtype=torch.int32)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    whole = fa.flash_attention_plain(qt, kt, vt, pos, pos, causal=causal,
                                     window=window)
    lse = fa.flash_lse_plain(qt, kt, pos, pos, causal=causal, window=window)
    want = fa.flash_attention_backward_plain(
        qt, kt, vt, whole, dot, lse, pos, pos, causal=causal, window=window)
    dk = dv = 0
    dq = []
    for r in range(TP):
        out, _, (gq, gk, gv) = _shard_backward(q, k, v, do, r, causal,
                                               window)
        bar = RTOL * float(whole.abs().max())
        assert float((out - whole[:, :, _shard(r, s)]).abs().max()) <= bar
        dq.append(gq)
        dk, dv = dk + gk, dv + gv
    _close([torch.cat(dq, dim=2).numpy(), dk.numpy(), dv.numpy()],
           [w.numpy() for w in want], case)


@pytest.mark.parametrize("r", range(TP))
@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_kernel_route_matches_reference_vjp(case, r):
    """``attend``'s kernel route (q scaled by hd ** -0.5, the transposed
    views, ``FlashAttentionFn``) on shard r against ``jax.vjp`` of the
    reference's ``_attend_local`` with the shard's positions."""
    q, k, v, do, causal, window = _inputs(case)
    s, hd = k.shape[2], q.shape[-1]
    rows = _shard(r, s)
    qs, ks, vs, dos = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                       for a in (q[:, :, rows] * hd ** 0.5, k, v,
                                 do[:, :, rows]))
    qpos = np.arange(s, dtype=np.int32)[rows]
    kpos = np.arange(s, dtype=np.int32)

    def ref(q_, k_, v_):
        return j_attn._attend_local(
            q_, k_, v_, q_positions=jnp.asarray(qpos),
            kv_positions=jnp.asarray(kpos), causal=causal, window=window,
            chunk=8)
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
    _close([g.numpy() for g in got], [np.asarray(w) for w in want],
           f"{case} shard {r}")


@pytest.mark.parametrize("tiles", TILE_SIZES)
@pytest.mark.parametrize("window", [0, 300])
def test_live_tiles_on_an_offset_shard(tiles, window):
    """internlm2's shape cut to a 4-way split of 1024 positions: on every
    shard, a DEAD pair of tiles holds no valid pair and a FULL one only
    valid pairs; causal without a window, the shards' live (non-DEAD)
    tiles grow with r, the last shard meeting the most."""
    bq, bk = tiles
    s = 1024
    kpos = torch.arange(s, dtype=torch.int32)
    live = []
    for r in range(TP):
        qpos = kpos[_shard(r, s)]
        cls = fa.live_tiles(qpos, kpos, bq, bk, True, window)
        mask = fa.position_mask(qpos, kpos, True, window).expand(
            qpos.shape[0], s)
        for i in range(cls.shape[0]):
            for j in range(cls.shape[1]):
                tile = mask[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
                if cls[i, j] == fa.DEAD:
                    assert not tile.any(), (r, i, j)
                if cls[i, j] == fa.FULL:
                    assert tile.shape[1] == bk and tile.all(), (r, i, j)
        live.append(int((cls != fa.DEAD).sum()))
    if not window:
        assert live == sorted(live) and live[-1] > live[0], live
