"""olmoe-1b-7b [moe] — 64 experts top-8, every layer MoE
[arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    layer_pattern=(ATTN,),
    moe=MoEConfig(num_experts=64, top_k=8),
    mlp_act="silu",
)

SMOKE = ArchConfig(
    name="olmoe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=32,
    vocab_size=512,
    layer_pattern=(ATTN,),
    moe=MoEConfig(num_experts=8, top_k=2),
    mlp_act="silu",
    dtype="float32", param_dtype="float32",
)
