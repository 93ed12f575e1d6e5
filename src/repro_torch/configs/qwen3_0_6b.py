"""qwen3-0.6b [dense] -- 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf-verified]

Qwen3 uses an explicit head_dim=128 (decoupled from d_model/n_heads) and
per-head RMS qk-norm; the 0.6B ties embeddings."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    act="silu",
)
