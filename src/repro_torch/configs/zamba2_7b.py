"""zamba2-7b [hybrid] -- 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention block.
[arXiv:2411.15242; unverified]

Mamba2 blocks (expand=2, head P=64) with the weight-*shared* full-attention
block applied every 6 layers (Zamba2's shared-transformer design; the
per-invocation LoRA deltas are omitted -- DESIGN.md §5).  Sub-quadratic
(constant-size SSM state + periodic attention over a bounded window at
decode) => runs long_500k."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid_ssm",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    d_head=112,
    ssm_state=64,
    ssm_heads=112,           # 2*d_model / 64
    ssm_chunk=128,
    hybrid_attn_every=6,
    swa_window=4096,         # bound the shared-attn cache for long contexts
    act="silu",
    param_dtype="bfloat16",
)
