"""Mixture-of-Experts block: shared + routed experts, top-k, capacity-based.

Port of ``src/repro/models/moe.py``: the same init, ``MOE_TOKEN_CHUNK``,
``moe_block`` and capacity scheme.  Per-(token, expert) assignment ranks
are an exclusive cumsum over the one-hot assignment matrix; each expert
keeps its first C tokens (GShard-style dropping); the aux load-balancing
loss follows Switch, ``E * sum_e f_e * p_e``.

``_moe_tokens`` runs as three plain functions, each of which can be held
alone: ``route`` (the float32 router's top-k, ranks, capacity drops and
the (E, C) slot table), ``experts`` (the dispatch gather and the three
expert GEMMs in the compute type) and ``combine`` (each token's kept
expert outputs, gate-weighted, summed in float32).  The combine is a
gather: a token takes its kept (expert, slot) rows in ascending expert
order and adds them in float32 from 0, the order in which the reference's
scatter-add visits them, so no atomics run and the card gives the same
result from run to run.  Dropped assignments are masked, never indexed
out of range.

The model code places nothing on a mesh: the sharding rules
(``runtime/sharding.py``) carry the expert-TP and expert-parallel layouts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(gen, cfg: ModelConfig):
    d, de = cfg.d_model, cfg.d_expert
    e = cfg.n_experts
    p = {
        "router": L.dense_init(gen, (d, e), torch.float32),  # router in fp32
        "wg": L.dense_init(gen, (e, d, de), cfg.pdt),
        "wu": L.dense_init(gen, (e, d, de), cfg.pdt),
        "wd": L.dense_init(gen, (e, de, d), cfg.pdt),
    }
    if cfg.n_shared_experts:
        ds = de * cfg.n_shared_experts
        p["shared"] = {
            "wg": L.dense_init(gen, (d, ds), cfg.pdt),
            "wu": L.dense_init(gen, (d, ds), cfg.pdt),
            "wd": L.dense_init(gen, (ds, d), cfg.pdt),
        }
    return p


MOE_TOKEN_CHUNK = 65536


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots an expert for a block of ``t`` tokens: the reference's
    ``int(max(1, round(t * k / e * capacity_factor)))`` in Python floats
    (``round`` rounds half to even)."""
    return int(max(1, round(t * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


class Routing(NamedTuple):
    """What ``route`` decides for a (T, d) token block."""

    gates: torch.Tensor    # (T, E) float32 softmax of the router logits
    topi: torch.Tensor     # (T, k) int64 experts, descending gate
    topv: torch.Tensor     # (T, k) float32 gates, normalised over the k
    assign: torch.Tensor   # (T, E) int32 one-hot of topi, before drops
    rank: torch.Tensor     # (T, k) int32 the assignment's slot
    keep: torch.Tensor     # (T, k) bool, rank < capacity
    tok_ids: torch.Tensor  # (E, C) int32 token of each slot; T when empty


def route(logits, cfg: ModelConfig) -> Routing:
    """Top-k routing of float32 router ``logits`` (T, E).

    The top k come from a stable descending sort, which gives
    ``jax.lax.top_k``'s order: descending values, the lower expert first
    on a tie.  Ranks are an exclusive int32 cumsum of the one-hot
    ``assign`` over tokens; an assignment whose rank reaches the capacity
    is dropped.  ``tok_ids`` is filled through a dump slot past the (E, C)
    table, so a dropped assignment writes nowhere that is kept."""
    t, e = logits.shape
    k = cfg.top_k
    cap = capacity(t, cfg)
    gates = torch.softmax(logits, dim=-1)
    topi = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]
    topv = torch.take_along_dim(gates, topi, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    assign = torch.zeros((t, e), dtype=torch.int32, device=logits.device)
    assign.scatter_(1, topi, 1)
    ranks = torch.cumsum(assign, dim=0, dtype=torch.int32) - assign
    rank = torch.take_along_dim(ranks, topi, dim=-1)
    keep = rank < cap
    slot = torch.where(keep, topi * cap + rank, e * cap)
    tok = torch.arange(t, dtype=torch.int32, device=logits.device)
    tok_ids = torch.full((e * cap + 1,), t, dtype=torch.int32,
                         device=logits.device)
    tok_ids.scatter_(0, slot.reshape(-1), tok[:, None].expand(t, k)
                     .reshape(-1))
    return Routing(gates, topi, topv, assign, rank, keep,
                   tok_ids[:-1].reshape(e, cap))


def experts(xt, tok_ids, p, cfg: ModelConfig):
    """The routed experts' outputs (E, C, d) in ``xt``'s type: each slot's
    token gathered from ``xt`` (T, d) plus one zero row (empty slots), then
    ``(act(x Wg) * (x Wu)) Wd`` an expert, each weight cast to the compute
    type on every call, as the reference's einsums."""
    dt = xt.dtype
    xe = torch.cat([xt, xt.new_zeros((1, xt.shape[1]))])[tok_ids.long()]
    h = L.act_fn(cfg.act)(torch.bmm(xe, p["wg"].to(dt))) * \
        torch.bmm(xe, p["wu"].to(dt))
    return torch.bmm(h, p["wd"].to(dt))


def combine(ye, r: Routing):
    """Each token's output (T, d) in float32: its kept (expert, slot) rows
    of ``ye`` (E, C, d), in ascending expert order, each times its gate
    (cast to ``ye``'s type before the product) and taken to float32, summed
    from 0.  A dropped assignment adds nothing."""
    e, cap, d = ye.shape
    order = torch.argsort(r.topi, dim=-1, stable=True)
    topi, rank, keep, topv = (torch.take_along_dim(a, order, dim=-1)
                              for a in (r.topi, r.rank, r.keep, r.topv))
    rows = ye.reshape(e * cap, d)[topi * cap + rank.clamp(max=cap - 1)]
    part = (rows * topv.to(ye.dtype)[..., None]).to(torch.float32)
    part = torch.where(keep[..., None], part, 0.0)
    out = torch.zeros((part.shape[0], d), dtype=torch.float32,
                      device=ye.device)
    for j in range(part.shape[1]):
        out = out + part[:, j]
    return out


def moe_block(x, p, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-dim float32).

    Above ``MOE_TOKEN_CHUNK`` tokens, when the count divides evenly, the
    block runs chunk by chunk: the capacity is then a chunk's, and the aux
    loss is the chunks' mean.
    """
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    if t > MOE_TOKEN_CHUNK and t % MOE_TOKEN_CHUNK == 0:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for xi in xt.split(MOE_TOKEN_CHUNK):
            out, a = _moe_tokens(xi, p, cfg)
            aux = aux + a
            outs.append(out)
        # a float32 tensor divisor: a Python scalar one is a reciprocal
        # multiply on the card
        nc = torch.tensor(float(len(outs)), dtype=torch.float32,
                          device=x.device)
        return torch.cat(outs).reshape(b, s, d), aux / nc
    out, aux = _moe_tokens(xt, p, cfg)
    return out.reshape(b, s, d), aux


def _moe_tokens(xt, p, cfg: ModelConfig):
    """Route, compute and combine a flat (T, d) token block."""
    r = route(xt.to(torch.float32) @ p["router"].to(torch.float32), cfg)
    out = combine(experts(xt, r.tok_ids, p, cfg), r).to(xt.dtype)
    if cfg.n_shared_experts:
        out = out + L.gated_mlp(xt, p["shared"], cfg.act)
    frac_tokens = r.assign.to(torch.float32).mean(0)
    frac_probs = r.gates.mean(0)
    aux = cfg.n_experts * (frac_tokens * frac_probs).sum()
    return out, aux
