"""gemma3-4b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]. Sub-quadratic-enough for the
long_500k decode cell: 5/6 of layers read a 1024-token ring buffer; the
global layers are linear-in-S cache reads at decode (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig, ATTN, ATTN_LOCAL

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262_144,
    head_dim=256,
    layer_pattern=(ATTN_LOCAL, ATTN_LOCAL, ATTN_LOCAL, ATTN_LOCAL,
                   ATTN_LOCAL, ATTN),
    local_window=1024,
    mlp_act="gelu",
    rope_theta=1_000_000.0,
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=7,   # one period + 1 remainder layer
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    layer_pattern=(ATTN_LOCAL, ATTN_LOCAL, ATTN_LOCAL, ATTN_LOCAL,
                   ATTN_LOCAL, ATTN),
    local_window=16,
    mlp_act="gelu",
    subquadratic=True,
    dtype="float32", param_dtype="float32",
)
