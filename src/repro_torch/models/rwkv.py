"""RWKV-6 ("Finch") blocks: time-mix with data-dependent per-channel decay.

Port of ``src/repro/models/rwkv.py``.  The reference runs the recurrence as
an exact per-step ``lax.scan``; its TPU replacement is the GLA kernel, and
here the recurrence runs through that kernel's port (``kernels/rwkv_gla.py``
``gla_time_mix``: the CUDA kernel for CUDA tensors, its plain per-step
version for CPU tensors), with the state in and out.

Recurrence (head h, channels i->k, j->v):
  S_t = diag(w_t) S_{t-1} + k_t^T v_t
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv_gla as GLA
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

HEAD_DIM = 64


def rwkv_dims(cfg: ModelConfig):
    h = cfg.d_model // HEAD_DIM
    return h, HEAD_DIM


def init_time_mix(gen, cfg: ModelConfig):
    d = cfg.d_model
    h, dh = rwkv_dims(cfg)
    return {
        "mix": L.full(gen, (5, d), 0.5, cfg.pdt),   # r,k,v,w,g shift mixes
        "wr": L.dense_init(gen, (d, d), cfg.pdt),
        "wk": L.dense_init(gen, (d, d), cfg.pdt),
        "wv": L.dense_init(gen, (d, d), cfg.pdt),
        "wg": L.dense_init(gen, (d, d), cfg.pdt),
        "w0": L.full(gen, (d,), -6.0, torch.float32),  # decay bias
        "w_lora_a": L.dense_init(gen, (d, 64), cfg.pdt),
        "w_lora_b": L.dense_init(gen, (64, d), cfg.pdt, scale=1e-2),
        "u": L.full(gen, (h, dh), 0.0, torch.float32),  # per-head bonus
        "wo": L.dense_init(gen, (d, d), cfg.pdt),
        "ln_x": L.full(gen, (d,), 1.0, cfg.pdt),
    }


def init_channel_mix(gen, cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mix": L.full(gen, (2, d), 0.5, cfg.pdt),
        "wk": L.dense_init(gen, (d, ff), cfg.pdt),
        "wv": L.dense_init(gen, (ff, d), cfg.pdt),
        "wr": L.dense_init(gen, (d, d), cfg.pdt),
    }


def _token_shift(x, x_prev):
    """shifted[t] = x[t-1]; x_prev fills t=0 (decode carry)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _time_mix_proj(x, xs, p, cfg):
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mix[i] for i in range(5))
    r = xr @ p["wr"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    v = xv @ p["wv"].to(x.dtype)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    logw = -torch.exp(
        p["w0"] + (torch.tanh(xw @ p["w_lora_a"].to(x.dtype))
                   @ p["w_lora_b"].to(x.dtype)).to(torch.float32))
    w = torch.exp(logw)                                 # (B,S,d) in (0,1)
    return r, k, v, g, w


def recurrence_inputs(r, k, v, w, p, cfg: ModelConfig):
    """The ``gla_time_mix`` inputs ``time_mix`` makes of the projections
    r, k, v (B, S, d) and w (B, S, d) float32: each as float32 (B * H, S,
    64), contiguous, and ``u`` (H, 64)."""
    bsz, s, _ = r.shape
    h, dh = rwkv_dims(cfg)

    def rows(t):
        return (t.to(torch.float32).reshape(bsz, s, h, dh).transpose(1, 2)
                .reshape(bsz * h, s, dh).contiguous())

    return rows(r), rows(k), rows(v), rows(w), p["u"]


def time_mix(x, x_prev, state, p, cfg: ModelConfig):
    """x: (B,S,d); x_prev: (B,d) shift carry; state: (B,H,dk,dv) fp32, or
    ``None`` for a zero state.  Returns (y, new_x_prev, new_state)."""
    bsz, s, d = x.shape
    h, dh = rwkv_dims(cfg)
    xs = _token_shift(x, x_prev)
    r, k, v, g, w = _time_mix_proj(x, xs, p, cfg)
    st = None if state is None else state.reshape(bsz * h, dh, dh)
    y, st = GLA.gla_time_mix(*recurrence_inputs(r, k, v, w, p, cfg), st)
    y = y.reshape(bsz, h, s, dh).transpose(1, 2).reshape(bsz, s, d)
    y = y.to(x.dtype)
    y = L.rms_norm(y, p["ln_x"]) * g
    y = y @ p["wo"].to(x.dtype)
    return y, x[:, -1], st.reshape(bsz, h, dh, dh)


def channel_mix(x, x_prev, p, cfg: ModelConfig):
    xs = _token_shift(x, x_prev)
    mix = p["mix"].to(x.dtype)
    xk = x + (xs - x) * mix[0]
    xr = x + (xs - x) * mix[1]
    k = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    return torch.sigmoid(xr @ p["wr"].to(x.dtype)) * (
        k @ p["wv"].to(x.dtype)), x[:, -1]
