"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2
[arXiv:2402.19427; unverified]. Pattern: (rglru, rglru, local-attn)
repeating; MQA (kv=1); sub-quadratic (RG-LRU state + bounded window)."""
from repro_torch.configs.base import ArchConfig, ATTN_LOCAL, RGLRU

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    local_window=2048,
    rglru_width=4096,
    mlp_act="gelu",
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=4,  # one full period + remainder
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    local_window=16,
    rglru_width=64,
    mlp_act="gelu",
    subquadratic=True,
    dtype="float32", param_dtype="float32",
)
