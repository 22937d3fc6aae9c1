"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution
[arXiv:2409.12191; hf]. Vision frontend is a STUB per the assignment:
input_specs supplies precomputed patch embeddings (early fusion over the
first num_patches positions); M-RoPE sections (16, 24, 24) rotate the
temporal/height/width position streams."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    layer_pattern=(ATTN,),
    mlp_act="silu",
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
    num_patches=256,
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen2vl-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    layer_pattern=(ATTN,),
    mlp_act="silu",
    mrope_sections=(2, 3, 3),
    frontend="vision_stub",
    num_patches=16,
    dtype="float32", param_dtype="float32",
)
