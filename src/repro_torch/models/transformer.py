"""Model assembly: init, ``forward_hidden`` and ``forward``.

Port of ``src/repro/models/transformer.py`` for the ``dense`` family (GQA
attention with qk-norm / QKV bias, gated or plain MLP; qwen3-0.6b) and the
``rwkv`` family (RWKV-6 time-mix + channel-mix; rwkv6-3b).  The other
families raise ``NotImplementedError`` naming the ROADMAP item that ports
them.

Parameters are a dict shaped like the reference's tree, except that the
per-layer stack is a list: ``params["layers"][i]["attn"]["wq"]`` here is
``params["layers"]["attn"]["wq"][i]`` there (``models/convert.py`` moves a
tree across).  The layers run as a Python loop (the reference's
``lax.scan``); remat comes with training.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as RWKV
from repro_torch.models.config import ModelConfig

#: The ROADMAP item that ports each model family not ported yet.
UNPORTED_FAMILIES = {
    "moe": "A10 (the moe family, qwen2-moe)",
    "mla_moe": "A10 (the mla_moe family, deepseek-v3)",
    "hybrid_ssm": "A10 (the hybrid_ssm family, zamba2)",
    "encdec": "A10 (the encdec family, whisper)",
    "vlm": "A10 (the vlm family, qwen2-vl)",
}


def check_family(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless ``cfg`` runs in the port."""
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP "
            f"{UNPORTED_FAMILIES[cfg.family]}")
    if cfg.family not in ("dense", "rwkv"):
        raise ValueError(cfg.family)
    if cfg.family == "dense":
        A.check_config(cfg)


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; raises a
    clear ``RuntimeError`` for a CUDA device when PyTorch sees none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for, but torch.cuda.is_available() "
            f"is False: no CUDA device is visible to PyTorch.  Pass "
            f"device='cpu' to run on the CPU.")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_mlp(gen, cfg: ModelConfig, d_ff=None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.mlp_type == "plain":
        return {"wi": L.dense_init(gen, (d, ff), cfg.pdt),
                "wo": L.dense_init(gen, (ff, d), cfg.pdt)}
    return {"wg": L.dense_init(gen, (d, ff), cfg.pdt),
            "wu": L.dense_init(gen, (d, ff), cfg.pdt),
            "wd": L.dense_init(gen, (ff, d), cfg.pdt)}


def _init_dense_layer(gen, cfg: ModelConfig):
    return {
        "ln1": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "attn": A.init_attn(gen, cfg),
        "ln2": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "mlp": _init_mlp(gen, cfg),
    }


def _init_rwkv_layer(gen, cfg: ModelConfig):
    return {
        "ln1": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "tmix": RWKV.init_time_mix(gen, cfg),
        "ln2": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "cmix": RWKV.init_channel_mix(gen, cfg),
    }


def init_model(seed: int, cfg: ModelConfig, device="cuda"):
    """Random parameters from ``seed``, drawn on ``device`` (the card by
    default).  Shapes, dtypes and scales are the reference's (embed 0.02,
    ``w0`` -6, mixes 0.5, ``u`` 0, ``w_lora_b`` 1e-2, norms 1, the rest
    ``fan_in ** -0.5``); the values are ``torch.Generator``'s."""
    check_family(cfg)
    gen = generator(seed, device)
    d = cfg.d_model
    params = {
        "embed": L.dense_init(gen, (cfg.vocab, d), cfg.pdt, scale=0.02),
        "final_norm": L.full(gen, (d,), 1.0, cfg.pdt),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.vocab, d), cfg.pdt,
                                         scale=0.02)
    layer_init = (_init_dense_layer if cfg.family == "dense"
                  else _init_rwkv_layer)
    params["layers"] = [layer_init(gen, cfg) for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# Layer bodies (prefill)
# ---------------------------------------------------------------------------


def _dense_layer(x, p, cfg: ModelConfig, positions):
    h = A.attn_block(L.rms_norm(x, p["ln1"]), p["attn"], cfg, positions)
    x = x + h
    return x + L.mlp_apply(L.rms_norm(x, p["ln2"]), p["mlp"], cfg.act)


def _rwkv_layer(x, p, cfg: ModelConfig):
    zero_prev = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                            device=x.device)
    y, _, _ = RWKV.time_mix(L.rms_norm(x, p["ln1"]), zero_prev, None,
                            p["tmix"], cfg)
    x = x + y
    y, _ = RWKV.channel_mix(L.rms_norm(x, p["ln2"]), zero_prev, p["cmix"],
                            cfg)
    return x + y


# ---------------------------------------------------------------------------
# Forward (prefill): tokens -> logits
# ---------------------------------------------------------------------------


def forward_hidden(params, tokens, cfg: ModelConfig, extra_embeds=None):
    """tokens: (B, S) integer.  Returns (hidden (B, S, d) post-final-norm,
    aux_loss 0-dim float32).  ``extra_embeds`` (the vlm and encdec stubs)
    comes with those families."""
    check_family(cfg)
    if extra_embeds is not None:
        raise NotImplementedError("extra_embeds is not ported yet: ROADMAP "
                                  "A10 (the vlm and encdec families)")
    x = params["embed"][tokens].to(cfg.cdt)
    s = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "dense":
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        for lp in params["layers"]:
            x = _dense_layer(x, lp, cfg, positions)
    else:
        for lp in params["layers"]:
            x = _rwkv_layer(x, lp, cfg)
    return L.rms_norm(x, params["final_norm"]), aux


def unembed(params, x):
    """Logits of hidden ``x`` (B, S, d): ``x @ unembed.T`` in x's type."""
    table = params.get("unembed", params["embed"])
    return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))


def forward(params, tokens, cfg: ModelConfig, extra_embeds=None):
    """Full forward: (logits (B, S, V), aux)."""
    x, aux = forward_hidden(params, tokens, cfg, extra_embeds=extra_embeds)
    return unembed(params, x), aux
