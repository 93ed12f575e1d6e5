"""Single-token decode with per-layer caches (the serve step's substrate).

Port of ``src/repro/models/decode.py`` for the ``dense`` and ``rwkv``
families.  The caches keep the reference's keys and stacked layouts:

  dense : k, v  (L, B, S_kv, Hkv, Dh) in the compute type
  rwkv  : state (L, B, H, dk, dv) float32 + shift carries tshift, cshift
          (L, B, d) in the compute type

``forward_decode`` writes each step into the given cache tensors in place
(the reference returns updated copies) and returns the same dict.  The
rwkv step runs ``time_mix`` with S = 1 and the carried state, so every
decode step goes through the ``gla_time_mix`` kernel on the card.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as RWKV
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def cache_spec(cfg: ModelConfig, batch: int, kv_len: int, dtype=None):
    """Shape/dtype of each cache tensor: ``{name: (shape, dtype)}``."""
    T.check_family(cfg)
    dt = dtype or cfg.cdt
    if cfg.family == "dense":
        shape = (cfg.n_layers, batch, kv_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}
    h, dh = RWKV.rwkv_dims(cfg)
    return {
        "state": ((cfg.n_layers, batch, h, dh, dh), torch.float32),
        "tshift": ((cfg.n_layers, batch, cfg.d_model), dt),
        "cshift": ((cfg.n_layers, batch, cfg.d_model), dt),
    }


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, device="cuda"):
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_spec(cfg, batch, kv_len).items()}


def forward_decode(params, token, cache, pos, cfg: ModelConfig):
    """token: (B, 1) integer; pos: the current absolute position (int).

    Returns (logits (B, 1, V), cache), the cache updated in place.
    """
    T.check_family(cfg)
    pos = int(pos)
    x = params["embed"][token].to(cfg.cdt)
    if cfg.family == "dense":
        for i, lp in enumerate(params["layers"]):
            h, _, _ = A.decode_attn(L.rms_norm(x, lp["ln1"]), lp["attn"],
                                    cfg, cache["k"][i], cache["v"][i], pos)
            x = x + h
            x = x + L.mlp_apply(L.rms_norm(x, lp["ln2"]), lp["mlp"],
                                cfg.act)
    else:
        for i, lp in enumerate(params["layers"]):
            y, ts, st = RWKV.time_mix(L.rms_norm(x, lp["ln1"]),
                                      cache["tshift"][i], cache["state"][i],
                                      lp["tmix"], cfg)
            x = x + y
            y, cs = RWKV.channel_mix(L.rms_norm(x, lp["ln2"]),
                                     cache["cshift"][i], lp["cmix"], cfg)
            x = x + y
            cache["state"][i].copy_(st)
            cache["tshift"][i].copy_(ts)
            cache["cshift"][i].copy_(cs)
    x = L.rms_norm(x, params["final_norm"])
    return T.unembed(params, x), cache
