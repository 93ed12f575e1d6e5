"""qwen2-moe-a2.7b [moe] -- 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4; 4 shared + 60 routed.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf-verified]

The assigned d_ff=1408 is the per-expert width (moe_intermediate_size);
the shared expert is 4x that (5632), expressed as n_shared_experts=4."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    d_head=128,
    qkv_bias=True,
    rope_theta=1e6,
    moe=True,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    d_expert=1408,
    act="silu",
)
