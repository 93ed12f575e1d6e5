"""Model assembly: init, ``forward_hidden`` and ``forward``.

Port of ``src/repro/models/transformer.py`` for all seven of its families:
``dense`` and ``vlm`` (GQA attention with qk-norm / QKV bias / a sliding
window / M-RoPE, gated or plain MLP; qwen3-0.6b, h2o-danube-1.8b,
qwen2-vl-72b), ``moe`` (GQA attention + shared and routed top-k experts,
the router's aux loss, an optional ``first_k_dense`` prefix of dense
layers; qwen2-moe-a2.7b), ``mla_moe`` (multi-head latent attention in
every layer, a dense-FFN prefix of ``first_k_dense`` layers, then shared
and routed experts, and the multi-token-prediction head ``mtp``;
deepseek-v3-671b), ``hybrid_ssm`` (Mamba2 blocks, ``models/ssm.py``, with
one weight-shared dense attention block ``shared_attn`` run after every
``hybrid_attn_every``-th layer; zamba2-7b), ``encdec`` (a bidirectional
encoder over stub frame embeddings and a causal decoder with
cross-attention; whisper-base) and ``rwkv`` (RWKV-6 time-mix +
channel-mix; rwkv6-3b).

Parameters are a dict shaped like the reference's tree, except that the
per-layer stack is a list: ``params["layers"][i]["attn"]["wq"]`` here is
``params["layers"]["attn"]["wq"][i]`` there (``models/convert.py`` moves a
tree across; ``params["encoder"]`` and ``params["dense_layers"]``
likewise; the ``mtp`` and ``shared_attn`` groups are one plain nested dict
on both sides).  The layers run as a Python loop (the reference's
``lax.scan``).  With ``cfg.remat``, while autograd records, each layer
body runs under ``torch.utils.checkpoint`` (non-reentrant): its
activations are recomputed in the backward, as the reference's
``jax.checkpoint`` (``_maybe_remat``) has them; a hybrid_ssm layer's body
is its SSM layer and, where it runs, the shared block.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as _checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

#: The ROADMAP item that ports each model family not ported yet: none.
UNPORTED_FAMILIES: dict = {}
#: The families the port runs: all seven of the reference's.
FAMILIES = ("dense", "vlm", "moe", "mla_moe", "hybrid_ssm", "encdec",
            "rwkv")


def check_family(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless ``cfg`` runs in the port."""
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP "
            f"{UNPORTED_FAMILIES[cfg.family]}")
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    if cfg.family != "rwkv":
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


def _init_dense_layer(gen, cfg: ModelConfig, cross: bool = False):
    p = {
        "ln1": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "attn": A.init_attn(gen, cfg),
        "ln2": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "mlp": _init_mlp(gen, cfg),
    }
    if cross:
        p["ln_x"] = L.full(gen, (cfg.d_model,), 1.0, cfg.pdt)
        p["xattn"] = A.init_attn(gen, cfg)
    return p


def _init_layer_attn(gen, cfg: ModelConfig):
    """A moe / mla_moe layer's attention: MLA for mla_moe, GQA for moe."""
    if cfg.family == "mla_moe":
        return MLA.init_mla(gen, cfg)
    return A.init_attn(gen, cfg)


def _init_prefix_layer(gen, cfg: ModelConfig):
    """A ``first_k_dense`` layer: the family's attention, a dense FFN."""
    return {
        "ln1": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "attn": _init_layer_attn(gen, cfg),
        "ln2": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "mlp": _init_mlp(gen, cfg),
    }


def _init_moe_layer(gen, cfg: ModelConfig):
    return {
        "ln1": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "attn": _init_layer_attn(gen, cfg),
        "ln2": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "moe": MOE.init_moe(gen, cfg),
    }


def _init_mtp(gen, cfg: ModelConfig):
    """DeepSeek-V3's multi-token-prediction head: ``fuse`` (2d, d), a dense
    (GQA) layer and its norm."""
    d = cfg.d_model
    return {"fuse": L.dense_init(gen, (2 * d, d), cfg.pdt),
            "block": _init_dense_layer(gen, cfg),
            "norm": L.full(gen, (d,), 1.0, cfg.pdt)}


def _init_ssm_layer(gen, cfg: ModelConfig):
    # Mamba2 layers carry no separate MLP (Zamba2: the d_ff MLP lives in the
    # weight-shared attention block only).
    return {
        "ln1": L.full(gen, (cfg.d_model,), 1.0, cfg.pdt),
        "ssm": SSM.init_ssm(gen, cfg),
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
    if cfg.family == "encdec":
        params["encoder"] = [_init_dense_layer(gen, cfg)
                             for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = L.full(gen, (d,), 1.0, cfg.pdt)
        params["layers"] = [_init_dense_layer(gen, cfg, cross=True)
                            for _ in range(cfg.n_layers)]
        return params
    if cfg.family in ("moe", "mla_moe"):
        # the first_k_dense layers run a dense MLP in place of the experts
        nk = cfg.first_k_dense
        if nk:
            params["dense_layers"] = [_init_prefix_layer(gen, cfg)
                                      for _ in range(nk)]
        params["layers"] = [_init_moe_layer(gen, cfg)
                            for _ in range(cfg.n_layers - nk)]
        if cfg.mtp:
            params["mtp"] = _init_mtp(gen, cfg)
        return params
    if cfg.family == "hybrid_ssm":
        params["layers"] = [_init_ssm_layer(gen, cfg)
                            for _ in range(cfg.n_layers)]
        params["shared_attn"] = _init_dense_layer(gen, cfg)
        return params
    layer_init = (_init_rwkv_layer if cfg.family == "rwkv"
                  else _init_dense_layer)
    params["layers"] = [layer_init(gen, cfg) for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# Layer bodies (training and prefill)
# ---------------------------------------------------------------------------


def _dense_layer(x, p, cfg: ModelConfig, positions, *, causal=True,
                 enc_out=None, window=None):
    h = A.attn_block(L.rms_norm(x, p["ln1"]), p["attn"], cfg, positions,
                     causal=causal, window=window)
    x = x + h
    if enc_out is not None:
        h = A.attn_block(L.rms_norm(x, p["ln_x"]), p["xattn"], cfg, None,
                         causal=False, kv_x=enc_out)
        x = x + h
    return x + L.mlp_apply(L.rms_norm(x, p["ln2"]), p["mlp"], cfg.act)


def _layer_attn(xn, p, cfg: ModelConfig, positions):
    """A moe / mla_moe layer's causal attention of the normed ``xn``."""
    if cfg.family == "mla_moe":
        return MLA.mla_block(xn, p, cfg, positions)
    return A.attn_block(xn, p, cfg, positions)


def _prefix_layer(x, p, cfg: ModelConfig, positions):
    """A moe / mla_moe ``first_k_dense`` layer: the family's attention,
    then the dense FFN."""
    x = x + _layer_attn(L.rms_norm(x, p["ln1"]), p["attn"], cfg, positions)
    return x + L.mlp_apply(L.rms_norm(x, p["ln2"]), p["mlp"], cfg.act)


def _moe_layer(x, p, cfg: ModelConfig, positions):
    """(x, aux): attention, then the experts on the normed residual."""
    x = x + _layer_attn(L.rms_norm(x, p["ln1"]), p["attn"], cfg, positions)
    mo, aux = MOE.moe_block(L.rms_norm(x, p["ln2"]), p["moe"], cfg)
    return x + mo, aux


def _ssm_layer(x, p, cfg: ModelConfig):
    return x + SSM.ssm_block(L.rms_norm(x, p["ln1"]), p["ssm"], cfg)


def _hybrid_layer(x, p, shared, idx: int, cfg: ModelConfig, positions):
    """Layer ``idx`` of a hybrid_ssm stack: its SSM layer, then the
    weight-shared dense block ``shared`` after every ``hybrid_attn_every``-th
    layer (``idx % every == every - 1``; the block's attention takes the
    config's window)."""
    x = _ssm_layer(x, p, cfg)
    every = max(cfg.hybrid_attn_every, 1)
    if idx % every == every - 1:
        x = _dense_layer(x, shared, cfg, positions)
    return x


def _rwkv_layer(x, p, cfg: ModelConfig):
    zero_prev = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                            device=x.device)
    y, _, _ = RWKV.time_mix(L.rms_norm(x, p["ln1"]), zero_prev, None,
                            p["tmix"], cfg)
    x = x + y
    y, _ = RWKV.channel_mix(L.rms_norm(x, p["ln2"]), zero_prev, p["cmix"],
                            cfg)
    return x + y


def _maybe_remat(f, cfg: ModelConfig):
    """``f`` under ``torch.utils.checkpoint`` (non-reentrant) when
    ``cfg.remat`` is set and autograd records; ``f`` itself otherwise."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return f

    def body(*args, **kw):
        return _checkpoint.checkpoint(f, *args, use_reentrant=False, **kw)

    return body


# ---------------------------------------------------------------------------
# Forward (training and prefill): tokens -> logits
# ---------------------------------------------------------------------------


def _positions(cfg: ModelConfig, s: int, device):
    """Batch-free positions 0 .. s - 1: (S,), or (3, S) for M-RoPE, where
    the three streams coincide (text tokens; the vision stub's patches
    take text-linear ids too)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)
    return pos[None, :].expand(3, s) if cfg.mrope else pos


def encode(params, frames, cfg: ModelConfig):
    """The encdec family's encoder: the bidirectional dense stack over the
    stub frame embeddings ``frames`` (B, T, d), then ``enc_norm``.  Returns
    (B, T, d) in the compute type."""
    enc = frames.to(cfg.cdt)
    enc_pos = _positions(cfg, enc.shape[1], enc.device)
    body = _maybe_remat(_dense_layer, cfg)
    for lp in params["encoder"]:
        enc = body(enc, lp, cfg, enc_pos, causal=False)
    return L.rms_norm(enc, params["enc_norm"])


def forward_hidden(params, tokens, cfg: ModelConfig, extra_embeds=None):
    """tokens: (B, S) integer; extra_embeds: (B, P, d) modality-stub
    embeddings, prepended to the token embeddings (vlm patches), or the
    encoder's input frames (encdec, which needs them).

    Returns (hidden (B, S_total, d) post-final-norm, aux_loss 0-dim
    float32); for encdec S_total is the token count.
    """
    check_family(cfg)
    x = params["embed"][tokens].to(cfg.cdt)
    if extra_embeds is not None and cfg.family != "encdec":
        x = torch.cat([extra_embeds.to(cfg.cdt), x], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "rwkv":
        body = _maybe_remat(_rwkv_layer, cfg)
        for lp in params["layers"]:
            x = body(x, lp, cfg)
        return L.rms_norm(x, params["final_norm"]), aux
    enc = None
    if cfg.family == "encdec":
        if extra_embeds is None:
            raise ValueError("the encdec family needs stub frame embeddings "
                             "(extra_embeds)")
        enc = encode(params, extra_embeds, cfg)
    positions = _positions(cfg, x.shape[1], x.device)
    if cfg.family == "hybrid_ssm":
        body = _maybe_remat(_hybrid_layer, cfg)
        for idx, lp in enumerate(params["layers"]):
            x = body(x, lp, params["shared_attn"], idx, cfg, positions)
        return L.rms_norm(x, params["final_norm"]), aux
    body = _maybe_remat(_dense_layer, cfg)
    if cfg.family in ("moe", "mla_moe"):
        prefix = _maybe_remat(_prefix_layer, cfg)
        for lp in params.get("dense_layers", ()):
            x = prefix(x, lp, cfg, positions)
        body = _maybe_remat(_moe_layer, cfg)
        auxs = []
        for lp in params["layers"]:
            x, a = body(x, lp, cfg, positions)
            auxs.append(a)
        aux = aux + torch.stack(auxs).sum() * cfg.router_aux_coef
        return L.rms_norm(x, params["final_norm"]), aux
    for lp in params["layers"]:
        x = body(x, lp, cfg, positions, enc_out=enc)
    return L.rms_norm(x, params["final_norm"]), aux


def unembed(params, x):
    """Logits of hidden ``x`` (B, S, d): ``x @ unembed.T`` in x's type."""
    table = params.get("unembed", params["embed"])
    return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))


def forward(params, tokens, cfg: ModelConfig, extra_embeds=None):
    """Full forward: (logits (B, S_total, V), aux)."""
    x, aux = forward_hidden(params, tokens, cfg, extra_embeds=extra_embeds)
    return unembed(params, x), aux


def mtp_logits(params, tokens, hidden, cfg: ModelConfig):
    """DeepSeek-V3 multi-token prediction: predict t+2 from [h_t; e_{t+1}].

    ``hidden`` (B, S, d); the next token's embedding is the tokens'
    embedding rolled by -1 (the last position wraps to the first, as the
    reference's ``jnp.roll``); ``fuse`` maps the concatenation to d, the
    head's dense layer (outside remat, as the reference's) and norm follow,
    then the unembedding.  None when the parameters have no ``mtp``."""
    if "mtp" not in params:
        return None
    p = params["mtp"]
    emb_next = torch.roll(params["embed"][tokens].to(hidden.dtype), -1,
                          dims=1)
    fused = torch.cat([hidden, emb_next], dim=-1) @ p["fuse"].to(
        hidden.dtype)
    positions = _positions(cfg, fused.shape[1], fused.device)
    h = _dense_layer(fused, p["block"], cfg, positions)
    return unembed(params, L.rms_norm(h, p["norm"]))
