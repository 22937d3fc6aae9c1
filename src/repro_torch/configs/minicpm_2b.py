"""minicpm-2b [dense] — llama-like, trained with the WSD schedule
(warmup-stable-decay; wired in train/optimizer.py via train_schedule)
[arXiv:2404.06395; hf]."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    layer_pattern=(ATTN,),
    mlp_act="silu",
)

TRAIN_SCHEDULE = "wsd"

SMOKE = ArchConfig(
    name="minicpm-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=509,   # deliberately unpadded (exercises vocab padding)
    layer_pattern=(ATTN,),
    mlp_act="silu",
    dtype="float32", param_dtype="float32",
)
