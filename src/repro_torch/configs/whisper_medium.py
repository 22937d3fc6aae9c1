"""whisper-medium [audio] — encoder-decoder; conv frontend is a STUB
(input_specs supplies precomputed frame embeddings, 1500 frames)
[arXiv:2212.04356; unverified]. Decoder cells use the assigned shape's
seq_len structurally (whisper's real decoder caps at 448 — noted in
DESIGN.md); encoder positions are sinusoidal."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    layer_pattern=(ATTN,),
    mlp_act="gelu",
    encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    frontend="audio_stub",
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    layer_pattern=(ATTN,),
    mlp_act="gelu",
    encoder_decoder=True,
    encoder_layers=2,
    encoder_seq=30,
    frontend="audio_stub",
    dtype="float32", param_dtype="float32",
)
