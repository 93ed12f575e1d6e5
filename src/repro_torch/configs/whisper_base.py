"""whisper-base [audio] -- 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865;
encoder-decoder, conv frontend (stub).  [arXiv:2212.04356; unverified]

The conv1d frontend is a stub: ``input_specs()`` supplies precomputed frame
embeddings (B, 1500, d_model) straight into the encoder.  Decoder is causal
with cross-attention; decode shapes run the text decoder against a cached
encoder (DESIGN.md §5)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    d_head=64,
    encoder_layers=6,
    encoder_seq=1500,
    act="gelu",
    mlp_type="plain",
    frontend="audio_stub",
)
