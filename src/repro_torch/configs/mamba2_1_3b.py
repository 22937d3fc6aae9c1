"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]. state N=128, expand 2, head dim 64.
Runs long_500k: O(1) state per token."""
from repro_torch.configs.base import ArchConfig, SSM

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=(SSM,),
    ssm_state=128,
    ssm_expand=2,
    ssm_heads=64,          # inner 4096 / head dim 64
    conv_width=4,
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    layer_pattern=(SSM,),
    ssm_state=16,
    ssm_expand=2,
    ssm_heads=2,
    conv_width=4,
    subquadratic=True,
    dtype="float32", param_dtype="float32",
)
