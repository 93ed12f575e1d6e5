"""starcoder2-15b [dense] -- 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA, RoPE.  [arXiv:2402.19173; hf-verified]

StarCoder2 uses learned bias on QKV and a GELU MLP; we keep the framework's
gated-MLP form with gelu activation (d_ff as specified) -- noted in
DESIGN.md as a uniform-substrate simplification."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    d_head=128,
    qkv_bias=True,
    rope_theta=1e5,
    act="gelu",
    mlp_type="plain",
    param_dtype="bfloat16",
)
