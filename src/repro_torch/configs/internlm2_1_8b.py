"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
    layer_pattern=(ATTN,),
    mlp_act="silu",
)

SMOKE = ArchConfig(
    name="internlm2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    layer_pattern=(ATTN,),
    mlp_act="silu",
    dtype="float32", param_dtype="float32",
)
