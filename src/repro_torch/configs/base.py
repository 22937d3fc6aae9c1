"""Architecture + shape configuration schema (the reference's, as data).

Every architecture is a frozen ``ArchConfig``; every benchmark shape is a
``ShapeConfig``. The same fields, defaults and derived properties as
``repro.configs.base``; the reference's ``input_specs`` (abstract array
stand-ins for its dry run) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# Block kinds the model factory understands.
ATTN = "attn"            # global self-attention
ATTN_LOCAL = "attn_local"
RGLRU = "rglru"          # RecurrentGemma recurrent block
SSM = "ssd"              # Mamba-2 SSD block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    interleave: int = 1          # MoE every `interleave` layers (1 = all)
    shared_expert: bool = False  # llama4-style shared expert


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    layer_pattern: tuple = (ATTN,)   # repeating block pattern
    local_window: int = 1024
    mlp_act: str = "silu"         # silu | gelu | relu2 (squared relu)
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0            # mamba2 state size N
    ssm_heads: int = 0
    ssm_expand: int = 2
    rglru_width: int = 0          # recurrence width (= d_model usually)
    conv_width: int = 4           # temporal conv for ssm/rglru blocks
    rope_theta: float = 10_000.0
    mrope_sections: tuple = ()    # qwen2-vl M-RoPE (t, h, w) split
    encoder_decoder: bool = False # whisper
    encoder_layers: int = 0
    encoder_seq: int = 1500       # whisper frames after conv stub
    frontend: str = "none"        # none | vision_stub | audio_stub
    num_patches: int = 256        # vlm stub patch count
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # numerics / FT
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    abft: bool = False            # ABFT-protect dense projections
    # subquadratic? (decides long_500k applicability)
    subquadratic: bool = False
    # training
    remat: bool = True
    scan_layers: bool = True
    grad_accum_override: int = 0   # 0 = shape-based default

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 for clean 'model'-axis sharding + MXU lanes
        (MaxText-style padding; loss masks the padded slots)."""
        return ((self.vocab_size + 255) // 256) * 256

    def pattern_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6 N D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = (self.num_heads * hd + 2 * self.num_kv_heads * hd) * d \
            + self.num_heads * hd * d
        dense_mlp = 3 * d * f
        total = 0
        layers = self.num_layers
        for i in range(layers):
            kind = self.pattern_for_layer(i)
            if kind in (ATTN, ATTN_LOCAL):
                total += attn
            elif kind == RGLRU:
                w = self.rglru_width or d
                total += 2 * d * w + w * d + 3 * w + self.conv_width * w
            elif kind == SSM:
                inner = self.ssm_expand * d
                nheads = self.ssm_heads or (inner // 64)
                # in_proj d x (z, x, B, C, dt) + out_proj + conv (see ssm.py)
                total += d * (2 * inner + 2 * self.ssm_state + nheads) \
                    + inner * d \
                    + self.conv_width * (inner + 2 * self.ssm_state) \
                    + 3 * nheads + inner
            if kind in (ATTN, ATTN_LOCAL, RGLRU):
                if self.moe and (i % self.moe.interleave == self.moe.interleave - 1):
                    total += self.moe.num_experts * dense_mlp
                    if self.moe.shared_expert:
                        total += dense_mlp
                else:
                    total += dense_mlp
            total += 2 * d          # norms
        total += v * d              # embed
        if not self.tie_embeddings:
            total += v * d
        if self.encoder_decoder:
            enc = self.encoder_layers * (attn + dense_mlp + 2 * d)
            total += enc + self.encoder_layers * attn  # cross-attn in decoder
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE-aware) for 6 N_active D."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_mlp = 3 * d * f
        inactive = 0
        for i in range(self.num_layers):
            if self.pattern_for_layer(i) in (ATTN, ATTN_LOCAL, RGLRU):
                if self.moe and (i % self.moe.interleave == self.moe.interleave - 1):
                    inactive += (self.moe.num_experts - self.moe.top_k) * dense_mlp
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? Returns (ok, reason)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("pure full-attention arch: 500k-token decode has no "
                       "sub-quadratic path (DESIGN.md §4)")
    return True, ""
