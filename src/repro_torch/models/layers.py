"""Shared neural-net layers (pure functions over param dicts).

Port of ``src/repro/models/layers.py``, with the reference's dtype steps:
``rms_norm`` reduces in float32 and multiplies in the working type,
``layer_norm`` normalises in float32, ``apply_rope`` and ``apply_mrope``
rotate in float32 and cast once.  The init helpers draw from a
``torch.Generator``,
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


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm: mean and (population) variance in float32, the normalised
    value cast to x's type, then ``* scale + bias`` in x's type.  No model
    of the reference calls it; it is kept as the reference keeps it."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


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
# Rotary embeddings (standard + M-RoPE)
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


def apply_mrope(x, positions3, sections, theta: float = 1e4):
    """Qwen2-VL multimodal RoPE.

    x: (..., S, H, D); positions3: (..., 3, S), the temporal, height and
    width position ids.  The rotary half-dims are split into ``sections``
    (summing to D / 2); each section rotates with its own position stream.
    For text tokens all three streams are equal and this is ``apply_rope``.
    """
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    inv = rope_freqs(d, theta, x.device)                   # (D/2,)
    # the position stream of each frequency slot
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(list(sections), device=x.device),
        output_size=half)                                  # (D/2,)
    pos = positions3.index_select(-2, sec_id).movedim(-2, -1)  # (..., S, D/2)
    ang = pos.to(torch.float32) * inv
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------


class MetaGenerator:
    """Stands for a ``torch.Generator`` on ``meta``, which torch refuses:
    the init helpers build empty ``meta`` leaves from it and draw
    nothing."""

    device = torch.device("meta")


def dense_init(gen, shape, dtype, scale: float | None = None):
    """Normal(0, 1) * scale, scale ``fan_in ** -0.5`` by default (fan_in =
    shape[0]); drawn on ``gen``'s device.  Scaled in place: a float32
    draw is the only temporary (deepseek-v3's (256, 7168, 2048) expert
    weight is 15 GB of it).  On ``meta`` (a :class:`MetaGenerator`) an
    empty leaf of the shape and dtype, nothing drawn."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(dtype)


def full(gen, shape, value: float, dtype):
    """A constant parameter on ``gen``'s device (norm scales, mixes, w0)."""
    return torch.full(shape, value, dtype=dtype, device=gen.device)
