"""Single-token decode with per-layer caches (the serve step's substrate).

Port of ``src/repro/models/decode.py`` for all seven of its families.  The
caches keep the reference's keys and stacked layouts:

  dense/vlm : k, v  (L, B, S_kv, Hkv, Dh) in the compute type, S_kv capped
              at the window for SWA (a ring buffer); under ``kv_quant`` k,
              v int8 and k_scale, v_scale (L, B, S_kv, Hkv) float32
  moe       : k, v as dense (``kv_quant`` ignored, as the reference ignores
              it); a step runs the experts on its B tokens, so their
              capacity is computed from B; a ``first_k_dense`` prefix
              raises ``NotImplementedError``, as in the reference
  mla_moe   : latent (L, B, S_kv, kv_lora_rank + qk_rope_dim) in the
              compute type, the dense prefix's layers first: each layer's
              ``[c_kv | k_rope]`` (``mla.mla_decode``); the prefix runs its
              dense FFN, the rest their experts (capacity from B)
  hybrid_ssm: ssm (L, B, H, N, P) float32, each Mamba2 layer's state
              (``ssm.ssm_decode``) + the shared block's k, v (n_attn, B,
              S_kv, Hkv, Dh), an entry per invocation of the block (n_attn
              = max(1, L // hybrid_attn_every)), S_kv capped at the window;
              as the reference's decode, the block's step passes no window
              to ``decode_attn``, so a step past S_kv writes the last slot
  encdec    : self k, v (L, B, S_kv, Hkv, Dh) + cross xk, xv (L, B, T_enc,
              Hkv, Dh), precomputed from encoder features (``cross_cache``)
  rwkv      : state (L, B, H, dk, dv) float32 + shift carries tshift,
              cshift (L, B, d) in the compute type

``forward_decode`` writes each step into the given cache tensors in place
(the reference returns updated copies) and returns the same dict.  The
rwkv step runs ``time_mix`` with S = 1 and the carried state, so every
decode step goes through the ``gla_time_mix`` kernel on the card.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def cache_spec(cfg: ModelConfig, batch: int, kv_len: int, dtype=None):
    """Shape/dtype of each cache tensor: ``{name: (shape, dtype)}``."""
    T.check_family(cfg)
    dt = dtype or cfg.cdt
    if cfg.swa_window:
        kv_len = min(kv_len, cfg.swa_window)
    shape = (cfg.n_layers, batch, kv_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in ("dense", "vlm") and cfg.kv_quant:
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (shape[:-1], torch.float32),
                "v_scale": (shape[:-1], torch.float32)}
    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": (shape, dt), "v": (shape, dt)}
    if cfg.family == "mla_moe":
        width = cfg.kv_lora_rank + cfg.qk_rope_dim
        return {"latent": ((cfg.n_layers, batch, kv_len, width), dt)}
    if cfg.family == "hybrid_ssm":
        _, h, p = SSM.ssm_dims(cfg)
        attn = (n_invocations(cfg),) + shape[1:]
        return {"ssm": ((cfg.n_layers, batch, h, cfg.ssm_state, p),
                        torch.float32),
                "k": (attn, dt), "v": (attn, dt)}
    if cfg.family == "encdec":
        cross = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": (shape, dt), "v": (shape, dt), "xk": (cross, dt),
                "xv": (cross, dt)}
    h, dh = RWKV.rwkv_dims(cfg)
    return {
        "state": ((cfg.n_layers, batch, h, dh, dh), torch.float32),
        "tshift": ((cfg.n_layers, batch, cfg.d_model), dt),
        "cshift": ((cfg.n_layers, batch, cfg.d_model), dt),
    }


def n_invocations(cfg: ModelConfig) -> int:
    """The hybrid_ssm cache's count of shared-block entries: ``max(1,
    n_layers // hybrid_attn_every)``."""
    return max(1, cfg.n_layers // max(cfg.hybrid_attn_every, 1))


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, device="cuda"):
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_spec(cfg, batch, kv_len).items()}


def cross_cache(params, enc, cfg: ModelConfig):
    """The encdec cache's cross-attention entries from encoder features
    ``enc`` (B, T_enc, d): ``{"xk", "xv"}``, each (L, B, T_enc, Hkv, Dh) in
    enc's type, every decoder layer's ``xattn`` K and V of ``enc``."""
    kv = [A.cross_kv(enc, lp["xattn"]) for lp in params["layers"]]
    return {"xk": torch.stack([k for k, _ in kv]),
            "xv": torch.stack([v for _, v in kv])}


def forward_decode(params, token, cache, pos, cfg: ModelConfig):
    """token: (B, 1) integer; pos: the current absolute position (int).

    Returns (logits (B, 1, V), cache), the cache updated in place.
    """
    T.check_family(cfg)
    pos = int(pos)
    if cfg.family == "moe" and "dense_layers" in params:
        raise NotImplementedError(
            "decode of a moe model with a dense prefix (first_k_dense): "
            "the reference's forward_decode has none either")
    x = params["embed"][token].to(cfg.cdt)
    if cfg.family == "mla_moe":
        # the dense prefix's layers hold the cache's first entries
        layers = [(lp, False) for lp in params.get("dense_layers", ())] + \
            [(lp, True) for lp in params["layers"]]
        for i, (lp, routed) in enumerate(layers):
            h, _ = MLA.mla_decode(L.rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                                  cache["latent"][i], pos)
            x = x + h
            xn = L.rms_norm(x, lp["ln2"])
            x = x + (MOE.moe_block(xn, lp["moe"], cfg)[0] if routed
                     else L.mlp_apply(xn, lp["mlp"], cfg.act))
    elif cfg.family in ("dense", "vlm") and cfg.kv_quant:
        names = ("k", "v", "k_scale", "v_scale")
        for i, lp in enumerate(params["layers"]):
            h, _ = A.decode_attn_int8(
                L.rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                {n: cache[n][i] for n in names}, pos, window=cfg.swa_window)
            x = x + h
            x = x + L.mlp_apply(L.rms_norm(x, lp["ln2"]), lp["mlp"],
                                cfg.act)
    elif cfg.family == "hybrid_ssm":
        every = max(cfg.hybrid_attn_every, 1)
        shared = params["shared_attn"]
        for i, lp in enumerate(params["layers"]):
            h, st = SSM.ssm_decode(L.rms_norm(x, lp["ln1"]), lp["ssm"], cfg,
                                   cache["ssm"][i])
            x = x + h
            cache["ssm"][i].copy_(st)
            if i % every == every - 1:
                # the block's caches are indexed by invocation
                inv = min(i // every, n_invocations(cfg) - 1)
                h, _, _ = A.decode_attn(L.rms_norm(x, shared["ln1"]),
                                        shared["attn"], cfg, cache["k"][inv],
                                        cache["v"][inv], pos)
                x = x + h
                x = x + L.mlp_apply(L.rms_norm(x, shared["ln2"]),
                                    shared["mlp"], cfg.act)
    elif cfg.family != "rwkv":
        for i, lp in enumerate(params["layers"]):
            h, _, _ = A.decode_attn(L.rms_norm(x, lp["ln1"]), lp["attn"],
                                    cfg, cache["k"][i], cache["v"][i], pos,
                                    window=cfg.swa_window)
            x = x + h
            if cfg.family == "encdec":
                x = x + A.cross_decode_attn(
                    L.rms_norm(x, lp["ln_x"]), lp["xattn"], cfg,
                    cache["xk"][i], cache["xv"][i])
            if cfg.family == "moe":
                x = x + MOE.moe_block(L.rms_norm(x, lp["ln2"]), lp["moe"],
                                      cfg)[0]
            else:
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
