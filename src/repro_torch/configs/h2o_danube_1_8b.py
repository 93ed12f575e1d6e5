"""h2o-danube-1.8b [dense] -- 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf-verified]

The SWA window makes this arch sub-quadratic => it runs the long_500k cell
(DESIGN.md §5)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    d_head=80,
    swa_window=4096,
    rope_theta=1e4,
    act="silu",
)
