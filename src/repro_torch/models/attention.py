"""GQA attention with local windows, RoPE, KV caches, chunked scores.

The port of ``repro.models.attention``. Memory discipline as there:

  * train/prefill on the CPU: scores computed in query chunks
    (``Q_CHUNK``) so the (S x S) matrix never materializes;
  * decode, global layers: full-length cache, masked by key position;
  * decode, local layers: ring-buffer cache of ``window`` entries. Keys
    carry absolute positions, so masking is uniform:
    valid = (kpos >= 0) & (kpos <= q) & (kpos > q - window).

On a CUDA tensor :func:`attend` runs the hand-written flash kernel
(``repro_torch.kernels.flash_attention``): the scores never leave the
thread block. On a CPU tensor it runs the reference's chunked math
(:func:`_attend_local`). Both scale q by ``hd ** -0.5`` in q's dtype before
any product and return zero for a query row with no valid key.

Decode writes the new token into the cache it is given, in place (the
reference returns an updated copy; the port saves a copy of the whole cache
per layer and step).

On a mesh (``repro_torch.dist.sharding.active_mesh``, ``DTensor`` inputs)
:func:`attend` runs the same routes on each rank's local tensors through
``local_map`` (the reference's ``shard_map``). Context parallelism: with a
``model`` axis of tp > 1 and Sq divisible by it, the query sequence (and
its positions) is split over ``model`` while k / v are replicated, so the
flash kernels run on a query shard whose positions start at r * Sq / tp;
k's and v's gradients leave the body as partial sums over ``model``
(``in_grad_placements``), the reference's "small psums for the k/v
gradients". Otherwise the rows split over the data axes only.

All projections route through ft_einsum (paper ABFT, config-switched).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.dist import sharding as shd
from repro_torch.ft.abft_dense import ft_einsum
from repro_torch.kernels.flash_attention import (flash_attention,
                                                  position_mask)
from repro_torch.models import layers as L

Q_CHUNK = 1024
NEG_POS = -(1 << 30)


def _tp_size() -> int:
    mesh = shd.active_mesh()
    return shd.mesh_shape(mesh).get("model", 1) if mesh is not None else 1


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, Len, KV, hd)
    v: torch.Tensor          # (B, Len, KV, hd)
    positions: torch.Tensor  # (Len,) int32 absolute positions (NEG_POS = empty)


def init_cache(cfg, batch: int, max_len: int, *, window: int = 0,
               dtype: torch.dtype = torch.bfloat16, device=None) -> KVCache:
    """window > 0 -> ring buffer of ``window`` entries."""
    length = min(max_len, window) if window else max_len
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, length, kv, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((length,), NEG_POS, dtype=torch.int32,
                              device=device))


def init_attention(gen: torch.Generator, cfg,
                   dtype: torch.dtype) -> L.Tree:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    specs = {
        "wq": ((d, cfg.num_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ((cfg.num_heads, hd, d), ("heads", "head_dim", "embed")),
    }
    return L.build(gen, specs, dtype)


def _block_attend(q, k, v, mask):
    """q (B,Sq,KV,G,hd), k/v (B,Skv,KV,hd), mask (Sq, Skv)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    while mask.dim() < s.dim():
        mask = mask[None]
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                          device=s.device))
    p = torch.softmax(s, dim=-1)
    # rows with no valid key (e.g. cold ring slots) -> zero output
    any_valid = mask.any(dim=-1, keepdim=True)
    p = torch.where(any_valid, p, torch.zeros((), dtype=p.dtype,
                                              device=p.device))
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def _attend_local(q, k, v, *, q_positions, kv_positions, causal, window,
                  chunk):
    """Chunked attention: the reference's math, query chunk by chunk."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = L.scaled(q, hd ** -0.5).reshape(b, sq, kvh, h // kvh, hd)
    outs = []
    for start in range(0, sq, chunk):
        stop = min(start + chunk, sq)
        mask = position_mask(q_positions[start:stop], kv_positions, causal,
                             window)
        outs.append(_block_attend(qg[:, start:stop], k, v, mask).reshape(
            b, stop - start, h, hd))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _attend_kernel(q, k, v, *, q_positions, kv_positions, causal, window,
                   chunk=Q_CHUNK):
    """The flash kernel on the (B, S, H, hd) tensors' transposed views (no
    copy: the kernel takes strides). It writes zero for a row with no valid
    key (``zero_empty_rows``; the reference kernel's finite NEG would give
    the mean of v). ``chunk`` is unused: the kernel never materializes the
    scores."""
    hd = q.shape[-1]
    qs = L.scaled(q, hd ** -0.5)
    return flash_attention(qs.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), q_positions, kv_positions,
                           causal=causal, window=window,
                           zero_empty_rows=True).transpose(1, 2)


def attend(q, k, v, *, q_positions, kv_positions, causal: bool = True,
           window: int = 0, chunk: int = Q_CHUNK):
    """Position-masked attention. q (B,Sq,H,hd); k/v (B,Skv,KV,hd).

    q_positions (Sq,), kv_positions (Skv,) are absolute. Mask:
      valid = kpos >= 0 & (causal -> kpos <= qpos)
                        & (window -> kpos > qpos - window)
    Query head h reads KV head h // (H / KV). A row with no valid key is
    zero. CUDA tensors run the flash kernel, CPU tensors the chunked math;
    ``DTensor`` q / k / v run them on each rank's shard (module docstring).
    """
    route = _attend_local if q.device.type == "cpu" else _attend_kernel
    mesh = shd.active_mesh()
    if mesh is None or not isinstance(q, DTensor):
        return route(q, k, v, q_positions=q_positions,
                     kv_positions=kv_positions, causal=causal,
                     window=window, chunk=chunk)
    sizes = shd.mesh_shape(mesh)
    b, sq = q.shape[0], q.shape[1]
    tp = sizes.get("model", 1)
    daxes = shd.data_axes(mesh)
    dp = 1
    for a in daxes:
        dp *= sizes[a]
    row = Shard(0) if b % dp == 0 and b >= dp else Replicate()
    split = tp > 1 and sq > 1 and sq % tp == 0
    rows = tuple(row if a != "model" else Replicate() for a in sizes)
    qs = tuple(row if a != "model" else Shard(1) if split else Replicate()
               for a in sizes)
    kv_grad = tuple(row if a != "model" else Partial() if split
                    else Replicate() for a in sizes)
    if split:
        n = sq // tp
        r = mesh.get_local_rank("model")
        q_positions = q_positions[r * n:(r + 1) * n]
        chunk = max(min(chunk, n), 128)

    def body(q, k, v):
        return route(q, k, v, q_positions=q_positions,
                     kv_positions=kv_positions, causal=causal,
                     window=window, chunk=chunk)
    return local_map(body, out_placements=(qs,),
                     in_placements=(qs, rows, rows),
                     in_grad_placements=(qs, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def apply_attention(cfg, params, x, *, positions, causal=True, window=0,
                    cache: Optional[KVCache] = None, pos=None,
                    kv_input=None, make_cache=False, max_len=0):
    """Attention block: projections + rope + (cache r/w) + attend + out proj.

    Modes:
      * train:            cache=None, make_cache=False
      * prefill:          cache=None, make_cache=True (returns fresh cache
                          of length max_len holding this call's k/v)
      * decode:           cache + int pos (one new token, written into the
                          cache in place)
      * cross-attention:  kv_input = encoder states (no rope, no cache)
    """
    # Sequence parallelism (Megatron-SP flavoured): the projections shard
    # over the query sequence; k / v are gathered over ``model`` for attend.
    if x.shape[1] > 1 and x.shape[1] % _tp_size() == 0:
        x = shd.constrain(x, ("batch", "seq_tp", None))
    kv_src = kv_input if kv_input is not None else x
    q = ft_einsum("bsd,dhk->bshk", x, params["wq"])
    k = ft_einsum("bsd,dhk->bshk", kv_src, params["wk"])
    v = ft_einsum("bsd,dhk->bshk", kv_src, params["wv"])
    dev = x.device

    if kv_input is not None:
        # cross-attention: every encoder frame visible, no rope.
        skv = k.shape[1]
        out = attend(q, k, v,
                     q_positions=torch.zeros(x.shape[1], dtype=torch.int32,
                                             device=dev),
                     kv_positions=torch.zeros(skv, dtype=torch.int32,
                                              device=dev), causal=False)
        return ft_einsum("bshk,hkd->bsd", out, params["wo"]), cache

    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    pos1d = positions if positions.dim() == 2 else positions[..., 0]

    if cache is not None:
        # decode: write (k, v, pos) into the (ring) buffer, attend over it.
        length = cache.k.shape[1]
        slot = int(pos) % length
        cache.k[:, slot:slot + 1] = k.to(cache.k.dtype)
        cache.v[:, slot:slot + 1] = v.to(cache.v.dtype)
        cache.positions[slot] = int(pos)
        new_cache = cache
        out = attend(q, cache.k, cache.v, q_positions=pos1d[0],
                     kv_positions=cache.positions, causal=True, window=window)
    elif make_cache:
        b, sq = x.shape[0], x.shape[1]
        length = min(max_len, window) if window else max_len
        p0 = pos1d[0].to(torch.int32)
        if length >= sq:
            ck = k.new_zeros((b, length) + tuple(k.shape[2:]))
            cv = v.new_zeros((b, length) + tuple(v.shape[2:]))
            ck[:, :sq] = k
            cv[:, :sq] = v
            cpos = torch.full((length,), NEG_POS, dtype=torch.int32,
                              device=dev)
            cpos[:sq] = p0
        else:  # prefill longer than the ring: keep the tail, preserving
            # the ring invariant slot(p) = p % length so decode writes land
            # on the oldest entry.
            shift = (sq - length) % length
            ck = torch.roll(k[:, -length:], shift, dims=1)
            cv = torch.roll(v[:, -length:], shift, dims=1)
            cpos = torch.roll(p0[-length:], shift, dims=0)
        new_cache = KVCache(ck, cv, cpos)
        out = attend(q, k, v, q_positions=pos1d[0],
                     kv_positions=pos1d[0], causal=causal, window=window)
    else:
        new_cache = None
        out = attend(q, k, v, q_positions=pos1d[0],
                     kv_positions=pos1d[0], causal=causal, window=window)

    return ft_einsum("bshk,hkd->bsd", out, params["wo"]), new_cache
