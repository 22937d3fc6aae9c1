"""nemotron-4-15b [dense] — GQA, squared-ReLU (ungated) MLP
[arXiv:2402.16819; unverified]."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256_000,
    layer_pattern=(ATTN,),
    mlp_act="relu2",
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="nemotron-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    layer_pattern=(ATTN,),
    mlp_act="relu2",
    tie_embeddings=False,
    dtype="float32", param_dtype="float32",
)
