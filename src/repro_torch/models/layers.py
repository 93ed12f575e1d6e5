"""Shared neural-net layers (pure functions over param dicts).

Port of ``src/repro/models/layers.py``, with the reference's dtype steps:
``rms_norm`` reduces in float32 and multiplies in the working type,
``apply_rope`` rotates in float32 and casts once.  M-RoPE comes with
qwen2-vl (ROADMAP A10).  The init helpers draw from a ``torch.Generator``,
whose numbers differ from ``jax.random``'s: shapes, dtypes and scales match
the reference's, values do not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm: the mean square in float32, ``x * inv * scale`` in x's type."""
    dt = x.dtype
    var = x.float().square().sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv[..., None] * scale.to(dt)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def gated_mlp(x, p, act: str = "silu"):
    """SwiGLU-style MLP: (act(x Wg) * (x Wu)) Wd."""
    a = act_fn(act)
    h = a(x @ p["wg"].to(x.dtype)) * (x @ p["wu"].to(x.dtype))
    return h @ p["wd"].to(x.dtype)


def mlp2(x, p, act: str = "gelu"):
    """Plain 2-matrix MLP (whisper / starcoder2-style)."""
    h = act_fn(act)(x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)


def mlp_apply(x, p, act: str = "silu"):
    """Dispatch on param keys: gated (wg/wu/wd) vs plain (wi/wo)."""
    return gated_mlp(x, p, act) if "wg" in p else mlp2(x, p, act)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv    # (..., S, D/2)
    sin = torch.sin(ang)[..., None, :]                    # (..., S, 1, D/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------


def dense_init(gen, shape, dtype, scale: float | None = None):
    """Normal(0, 1) * scale, scale ``fan_in ** -0.5`` by default (fan_in =
    shape[0]); drawn on ``gen``'s device."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def full(gen, shape, value: float, dtype):
    """A constant parameter on ``gen``'s device (norm scales, mixes, w0)."""
    return torch.full(shape, value, dtype=dtype, device=gen.device)
