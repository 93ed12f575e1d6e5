"""Optimizers (port of ``src/repro/optim``): functional AdamW with optional
int8 block-quantized state."""
