"""Flash attention (online-softmax GQA attention) on Hopper.

Replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (body ``_kernel``): q (B, H, Sq,
hd) against k, v (B, KV, Skv, hd), query head h reading KV head
h // (H / KV), masked by absolute positions with the mask contract of
``models.attention.attend``:

    valid = kpos >= 0 & (causal -> kpos <= qpos) & (window -> kpos > qpos - window)

The kernel computes what the reference kernel computes: unscaled scores in
f32, masked scores set to the finite ``NEG``, p = exp(s - running max) cast
to v's dtype before the P V product, f32 accumulation, the division by the
denominator at the end. So a query row with no valid key returns the mean
of v over all keys (exp(NEG - NEG) = 1), as the reference kernel does, or
zero with ``zero_empty_rows=True`` (``attend``'s contract; the kernel
writes the zero itself, so ``attend`` builds no mask on the card).

CUDA kernels in ``csrc/fk_attention.cu``, one thread block per (batch *
head, query tile) walking the KV tiles in a loop; the C side picks the
kernel and tile (``hw.FLASH_BLOCK_*``) from Sq, the dtype and the head dim:
``flash_mma_kernel<T, HD>`` for bf16 or fp16 at Sq > 16 and head dim 64 or
128 (the products on the tensor cores, ``mma.sync``),
``flash_kernel<T, HD, RI>`` for the rest (f32 FMAs on the CUDA cores:
every f32 launch, 2-byte decode launches and head dim 256); see the
source for the design and the bound (operations at prefill, KV bytes at
decode). It reads q, k, v and writes the output through their (batch,
head, sequence) strides, so transposed views of (B, S, H, hd) tensors need
no copy, and it masks the ragged ends of Sq and Skv itself: unlike the
reference, no shape must be padded to a tile. Head dims other than 64, 128 and 256 are zero-padded to the next of
them (a copy).

On the CPU the wrapper runs :func:`flash_attention_plain`, the masked
softmax of the reference's test oracle with the kernel's finite ``NEG``.
A CUDA tensor launches the kernel or raises; the wrapper counts launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import hw
from repro_torch.kernels import _build, ref

NEG = -1e30
# the C entry point's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def position_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                  causal: bool, window: int) -> torch.Tensor:
    """(Sq, Skv) validity of each key for each query, by absolute position."""
    m = (kv_positions >= 0)[None, :]
    if causal:
        m = m & (kv_positions[None, :] <= q_positions[:, None])
    if window:
        m = m & (kv_positions[None, :] > q_positions[:, None] - window)
    return m


def flash_attention_plain(q, k, v, q_positions, kv_positions, *,
                          causal: bool = True, window: int = 0,
                          zero_empty_rows: bool = False):
    """Plain PyTorch version: the full masked softmax in f32 (scores with
    the finite ``NEG`` where masked), cast to q's dtype."""
    ref.full_f32(q.device)
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kk.transpose(-1, -2))
    mask = position_mask(q_positions, kv_positions, causal, window)
    s = torch.where(mask, s, torch.tensor(NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    if zero_empty_rows:
        p = p * mask.any(dim=-1, keepdim=True)
    return torch.matmul(p, vv).to(q.dtype)


def _check_shapes(q, k, v, q_positions, kv_positions, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        raise ValueError(f"q (B, H, Sq, hd), k and v (B, KV, Skv, hd) with H "
                         f"a multiple of KV; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if tuple(q_positions.shape) != (q.shape[2],) \
            or tuple(kv_positions.shape) != (k.shape[2],):
        raise ValueError(f"positions must be (Sq,) and (Skv,); got "
                         f"{tuple(q_positions.shape)}, "
                         f"{tuple(kv_positions.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _strides(t: torch.Tensor, what: str) -> list[int]:
    """(batch, head, sequence) element strides of a tensor the kernel can
    address: contiguous head dim, 16-byte aligned rows and base."""
    align = 16 // t.element_size()
    st = list(t.stride()[:3])
    if t.stride(3) != 1 or any(s % align for s in st) \
            or t.data_ptr() % 16:
        raise ValueError(f"{what} must have a contiguous head dim and "
                         f"16-byte aligned rows; strides {tuple(t.stride())}")
    return st


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    zero_empty_rows: bool = False) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, KV, Skv, hd); positions absolute ints.

    Returns (B, H, Sq, hd) in q's dtype (f32, bf16 or fp16 on the
    card). A row
    with no valid key is the mean of v, or zero with ``zero_empty_rows``.
    The reference's ``block_q``/``block_k``/``interpret`` are TPU tiling
    controls; the kernel picks its tiles itself (``hw.FLASH_BLOCK_*``).
    """
    _check_shapes(q, k, v, q_positions, kv_positions, window)
    if _build.on_cpu(q, k, v, q_positions, kv_positions):
        return flash_attention_plain(q, k, v, q_positions, kv_positions,
                                     causal=causal, window=window,
                                     zero_empty_rows=zero_empty_rows)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share a dtype in float32/bfloat16/"
                         f"float16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if skv < 1:
        raise ValueError("flash_attention needs at least one key")
    hdp = next((d for d in hw.FLASH_HEAD_DIMS if d >= hd), None)
    if hdp is None:
        raise ValueError(f"head dim {hd} > {hw.FLASH_HEAD_DIMS[-1]}, the "
                         f"widest the kernel is built for")
    if hdp != hd:
        q, k, v = (F.pad(t, (0, hdp - hd)) for t in (q, k, v))
    out = torch.empty((b, sq, h, hdp), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if sq == 0:
        return out[..., :hd]
    qpos = q_positions.to(torch.int32).contiguous()
    kpos = kv_positions.to(torch.int32).contiguous()
    strides = (_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
               + _strides(out, "out"))
    code = _build.library("fk_attention").lib.fk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(), b, h, kvh, sq, skv, hdp, *strides,
        int(causal), int(window), int(zero_empty_rows), _DTYPES[q.dtype],
        _build.stream_of(q))
    _build.check(code, "flash_attention", "fk_attention")
    flash_attention.launches += 1
    return out if hdp == hd else out[..., :hd]


flash_attention.launches = 0
