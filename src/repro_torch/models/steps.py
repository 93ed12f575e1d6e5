"""The serve and prefill steps, and the next-token cross entropy.

Port of ``src/repro/models/steps.py`` (serving half): ``make_serve_step``,
``make_prefill_step`` and ``cross_entropy``.  Both steps run under
``torch.inference_mode()``.  The train step, ``chunked_softmax_xent`` and
the optimizer come with training (ROADMAP A10).
"""

from __future__ import annotations

import torch

from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def cross_entropy(logits, labels):
    """Mean next-token CE over valid (label >= 0) positions."""
    valid = labels >= 0
    labels_safe = labels.clamp(min=0)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels_safe[..., None].long(),
                                dim=-1)[..., 0]
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, token (B,1), cache, pos) -> logits, cache."""

    def serve_step(params, token, cache, pos):
        with torch.inference_mode():
            return D.forward_decode(params, token, cache, pos, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Prefill: the forward over a prompt, (params, tokens (B, S)) ->
    logits (B, S, V); the dense family's attention runs the
    ``flash_attention`` kernel, the rwkv family's time-mix ``gla_time_mix``."""

    def prefill_step(params, tokens, extra_embeds=None):
        with torch.inference_mode():
            logits, _ = T.forward(params, tokens, cfg,
                                  extra_embeds=extra_embeds)
        return logits

    return prefill_step
