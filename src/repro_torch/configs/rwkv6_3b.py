"""rwkv6-3b [ssm] -- 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536; Finch, data-dependent per-channel decay.
[arXiv:2404.05892; hf-verified]

Attention-free, constant-size recurrent state => runs long_500k."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # d_model / 64 time-mix heads
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    d_head=64,
    act="relu",
)
