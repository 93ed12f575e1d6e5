"""qwen2-vl-72b [vlm] -- 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf-verified]

Transformer BACKBONE only: the vision frontend is a stub --
``input_specs()`` supplies precomputed patch embeddings (B, 256, d_model)
prepended to the token stream; M-RoPE runs with coincident t/h/w ids for
text and the stub's linear ids for patches (DESIGN.md §5)."""

from repro_torch.models.config import ModelConfig

N_PATCHES = 256  # stub patch-embedding count per sample

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    d_head=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    act="silu",
    param_dtype="bfloat16",
)
