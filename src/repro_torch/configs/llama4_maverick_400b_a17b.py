"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, shared expert,
MoE on alternate layers (interleave 2, per HF config), early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Pattern period = 2 ('attn','attn') so the MoE interleave aligns with the
scan slots (slot 0 dense FFN, slot 1 MoE — see models/model.py note)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    layer_pattern=(ATTN, ATTN),
    moe=MoEConfig(num_experts=128, top_k=1, interleave=2,
                  shared_expert=True),
    mlp_act="silu",
    rope_theta=500_000.0,
    # 400B x (2+4+4)B/param does not fit 256 v5e chips; bf16 moments
    # (DESIGN.md §5 memory budget) bring params+opt to ~9.3 GiB/chip.
    opt_state_dtype="bfloat16",
    # 8-way microbatching: halves the remat activation stash again
    # (§Perf llama4 iteration 5) at the cost of more FSDP regathers.
    grad_accum_override=8,
)

SMOKE = ArchConfig(
    name="llama4-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    layer_pattern=(ATTN, ATTN),
    moe=MoEConfig(num_experts=4, top_k=1, interleave=2, shared_expert=True),
    mlp_act="silu",
    dtype="float32", param_dtype="float32",
)
