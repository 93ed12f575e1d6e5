"""deepseek-v3-671b [moe] -- 61L d_model=7168 128H (MLA) d_ff=2048(expert)
vocab=129280, MoE 256e top-8; MLA, 1 shared + 256 routed, MTP.
[arXiv:2412.19437; hf-verified]

Notes:
  * the assigned d_ff=2048 is the MoE expert width; the first_k_dense=3
    prefix layers use the dense FFN width 18432 (d_ff below), matching the
    HF config (intermediate_size vs moe_intermediate_size);
  * MLA dims: q_lora 1536, kv_lora 512, rope 64, nope 128, v 128 -- the
    decode cache stores only the 576-wide latent per token;
  * bf16 params + int8 optimizer state are required to fit the 256-chip
    single-pod mesh (DESIGN.md §6)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,              # dense-prefix FFN width (see module docstring)
    vocab=129280,
    d_head=128,
    rope_theta=1e4,
    moe=True,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    d_expert=2048,
    first_k_dense=3,
    capacity_factor=1.0,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    mtp=True,
    act="silu",
    param_dtype="bfloat16",
)
