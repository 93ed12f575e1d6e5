"""Unified model configuration covering all assigned architecture families.

Port of ``src/repro/models/config.py``: the same fields, defaults,
``reduced()`` and ``count_params``; ``pdt`` and ``cdt`` are ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | mla_moe | hybrid_ssm | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False                 # qwen3
    qkv_bias: bool = False                # qwen2.5 / qwen2-vl
    swa_window: Optional[int] = None      # h2o-danube sliding window
    rope_theta: float = 1e4
    mrope: bool = False                   # qwen2-vl M-RoPE (3 sections)
    mrope_sections: tuple = (16, 24, 24)  # t/h/w rotary sections (half-dims)
    tie_embeddings: bool = False
    act: str = "silu"                     # mlp activation (gelu for whisper/starcoder2)
    mlp_type: str = "gated"               # "gated" (SwiGLU) | "plain" (2-matrix)

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                     # per-expert hidden dim
    first_k_dense: int = 0                # deepseek-v3: first layers dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- MLA (deepseek-v3) ---
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    mtp: bool = False                     # multi-token-prediction extra head

    # --- SSM / hybrid (zamba2, rwkv6) ---
    ssm_state: int = 0                    # mamba2 state dim N
    ssm_heads: int = 0                    # mamba2 value heads
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0            # zamba2: shared attn block period

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500               # whisper-base post-conv frames

    # --- modality frontend stubs ---
    frontend: Optional[str] = None        # "vision_stub" | "audio_stub"

    # --- numerics / scaling ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 512                 # blockwise-attention query chunk
    kv_quant: bool = False                # int8 KV cache (decode; §Perf)
    # Kept so the configs copy across unchanged; the reference reads it
    # nowhere, and the port selects nothing by it: a CUDA tensor runs the
    # gla_time_mix kernel and a CPU tensor its plain version.
    rwkv_kernel: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def pdt(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def is_subquadratic(self) -> bool:
        """Can this architecture serve 500k-token contexts?  (DESIGN.md §5)"""
        return (self.family in ("hybrid_ssm", "rwkv")
                or self.swa_window is not None)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab=512,
            d_head=32,
        )
        if self.moe:
            # capacity_factor 4: no token dropping at smoke-test scale, so
            # batched forward == step-by-step decode (capacity drops are
            # batch-size-dependent and would break the consistency tests)
            small.update(n_experts=min(self.n_experts, 8),
                         n_shared_experts=min(self.n_shared_experts, 1),
                         top_k=min(self.top_k, 2), d_expert=64,
                         first_k_dense=min(self.first_k_dense, 1),
                         capacity_factor=4.0)
        if self.mla:
            small.update(q_lora_rank=64, kv_lora_rank=32, qk_rope_dim=16,
                         qk_nope_dim=16, v_head_dim=32, d_head=32)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_heads=4, ssm_chunk=32)
        if self.hybrid_attn_every:
            small.update(hybrid_attn_every=2)
        if self.mrope:
            # rotary sections must sum to the reduced head_dim / 2
            small.update(mrope_sections=(4, 6, 6))
        if self.encoder_layers:
            small.update(encoder_layers=2, encoder_seq=64)
        if self.swa_window:
            small.update(swa_window=32)
        small.update(overrides)
        return dataclasses.replace(self, **small)


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
    d, dh = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads

    def attn_params():
        if cfg.mla:
            q = d * cfg.q_lora_rank + cfg.q_lora_rank * nq * (
                cfg.qk_nope_dim + cfg.qk_rope_dim)
            kv = d * (cfg.kv_lora_rank + cfg.qk_rope_dim) + cfg.kv_lora_rank \
                * nq * (cfg.qk_nope_dim + cfg.v_head_dim)
            o = nq * cfg.v_head_dim * d
            return q + kv + o
        return d * dh * (nq + 2 * nkv) + nq * dh * d

    def mlp_params(ff):
        return (3 if cfg.mlp_type == "gated" else 2) * d * ff

    def moe_params():
        routed = cfg.n_experts * mlp_params(cfg.d_expert)
        shared = mlp_params(cfg.d_expert * cfg.n_shared_experts) \
            if cfg.n_shared_experts else 0
        return routed + shared + d * cfg.n_experts

    def ssm_params():
        # mamba2 block: in-proj [x|z|B|C|dt] + out-proj, expand factor 2
        dv = 2 * d
        return d * (2 * dv + 2 * cfg.ssm_state + cfg.ssm_heads) + dv * d

    total = cfg.vocab * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab * d

    if cfg.family in ("dense", "vlm"):
        total += cfg.n_layers * (attn_params() + mlp_params(cfg.d_ff))
    elif cfg.family in ("moe", "mla_moe"):
        dense_l = cfg.first_k_dense
        moe_l = cfg.n_layers - dense_l
        total += cfg.n_layers * attn_params()
        total += dense_l * mlp_params(cfg.d_ff if not cfg.moe else
                                      cfg.d_expert * (cfg.top_k + cfg.n_shared_experts))
        total += moe_l * moe_params()
    elif cfg.family == "hybrid_ssm":
        # Mamba2 layers carry no separate MLP; d_ff belongs to the single
        # weight-shared attention block (Zamba2 design).
        total += cfg.n_layers * ssm_params()
        total += attn_params() + mlp_params(cfg.d_ff)
    elif cfg.family == "rwkv":
        # time-mix (r,k,v,g,w projections + decay mlp) + channel-mix
        total += cfg.n_layers * (6 * d * d + 2 * d * cfg.d_ff + d * cfg.d_ff)
    elif cfg.family == "encdec":
        total += cfg.encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        # decoder has self + cross attention
        total += cfg.n_layers * (2 * attn_params() + mlp_params(cfg.d_ff))
    return int(total)
