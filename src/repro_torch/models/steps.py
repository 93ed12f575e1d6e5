"""train_step / eval_step / serve_step -- the functions the launchers run.

Port of ``src/repro/models/steps.py``: ``cross_entropy``,
``chunked_softmax_xent``, ``loss_fn``, ``make_train_step``,
``make_eval_step``, ``make_serve_step`` and ``make_prefill_step``.  The
serve and prefill steps run under ``torch.inference_mode()``; the train
step takes its gradients with ``torch.autograd.grad`` from parameters
detached from the caller's, so it is functional as the reference's is.
The loss adds the forward's ``aux``, the moe and mla_moe families' router
loss, and for a config with ``mtp`` (deepseek-v3) ``MTP_WEIGHT`` times the
multi-token-prediction head's CE, the head run on the embedding stream as
the reference runs it.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as _checkpoint

from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

MTP_WEIGHT = 0.3


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


def _chunk_nll(h, unembed, lab):
    """``(sum of nll, n valid)`` of one chunk: float32 logits from float32
    operands (the products of bfloat16 values are exact in float32, so this
    is the reference's ``preferred_element_type=float32`` einsum)."""
    logits = torch.einsum("bcd,vd->bcv", h.to(torch.float32),
                          unembed.to(torch.float32))
    valid = lab >= 0
    safe = lab.clamp(min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.sum()


def chunked_softmax_xent(hidden, unembed, labels, seq_chunk: int = 1024):
    """CE without materializing full (B, S, V) logits.

    Runs over sequence chunks; while autograd records, each chunk's (B, c,
    V) logits live only inside a checkpointed body (recomputed in the
    backward).  A tail of ``S % n_chunks`` tokens is computed directly, as
    the reference does.  Returns (sum_nll float32, n_valid int).
    """
    b, s, d = hidden.shape
    n_chunks = max(s // seq_chunk, 1)
    c = s // n_chunks
    body = _chunk_nll
    if torch.is_grad_enabled():
        def body(h, u, lab):
            return _checkpoint.checkpoint(_chunk_nll, h, u, lab,
                                          use_reentrant=False)
    s_nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(n_chunks):
        part, n = body(hidden[:, i * c:(i + 1) * c], unembed,
                       labels[:, i * c:(i + 1) * c])
        s_nll = s_nll + part
        n_valid = n_valid + n
    if n_chunks * c < s:
        part, n = _chunk_nll(hidden[:, n_chunks * c:], unembed,
                             labels[:, n_chunks * c:])
        s_nll = s_nll + part
        n_valid = n_valid + n
    return s_nll, n_valid


def loss_fn(params, batch, cfg: ModelConfig):
    """``(loss, {"ce", "aux"})``: the mean next-token CE of the batch's
    labels (-1 is ignored) plus the auxiliary loss.  With ``cfg.mtp`` and
    an ``mtp`` group, plus ``MTP_WEIGHT`` times the MTP head's CE
    (``metrics["mtp"]``): the head runs on the tokens' embeddings (the
    reference's cheap surrogate for the trunk's hidden state), its label at
    t the label at t + 1 where the label at t is valid, none at the last
    position."""
    hidden, aux = T.forward_hidden(params, batch["tokens"], cfg,
                                   extra_embeds=batch.get("extra_embeds"))
    unembed = params.get("unembed", params["embed"]).to(hidden.dtype)
    s_nll, n_valid = chunked_softmax_xent(hidden, unembed, batch["labels"])
    loss = s_nll / n_valid.clamp(min=1)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp and "mtp" in params:
        tokens, labels = batch["tokens"], batch["labels"]
        hidden = params["embed"][tokens].to(cfg.cdt)
        mlogits = T.mtp_logits(params, tokens, hidden, cfg)
        mtp_labels = torch.where(labels >= 0, torch.roll(labels, -1, dims=-1),
                                 -1)
        mtp_labels[:, -1] = -1
        mtp_loss = cross_entropy(mlogits, mtp_labels)
        loss = loss + MTP_WEIGHT * mtp_loss
        metrics["mtp"] = mtp_loss
    return loss + aux, metrics


def _detach(tree):
    return adamw.tree_map(lambda t: t.detach(), tree)


def grads_of(params, batch, cfg: ModelConfig):
    """``((loss, metrics), grads)`` of ``loss_fn`` at ``params``: the
    gradients of every parameter leaf (zeros for one the loss does not
    reach), in the parameters' tree; loss and metrics detached."""
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t

    with torch.enable_grad():
        tracked = adamw.tree_map(leaf, params)
        loss, metrics = loss_fn(tracked, batch, cfg)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = iter([torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, got)])
    grads = adamw.tree_map(lambda _: next(got), params)
    return (loss.detach(), _detach(metrics)), grads


def _place(tree, shardings):
    """Each leaf of ``tree`` on its ``NamedSharding`` in ``shardings``
    (``runtime/pspec.place``)."""
    from repro_torch.runtime import pspec
    return adamw.tree_map(pspec.place, tree, shardings)


def _gathered(tree, like):
    """A ``DTensor`` leaf of ``tree`` as a full tensor where the matching
    leaf of ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor

    def leaf(g, p):
        if isinstance(g, DTensor) and not isinstance(p, DTensor):
            return g.full_tensor()
        return g

    return adamw.tree_map(leaf, tree, like)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    n_micro: int = 1, grad_shardings=None):
    """Training step with optional gradient accumulation:
    ``(params, opt_state, batch) -> (params, opt_state, metrics)``, new
    trees (the arguments are not written), metrics ``ce``, ``aux``,
    ``loss`` and ``grad_norm``.

    ``n_micro`` > 1 splits the batch's leading dim into micro-batches and
    accumulates float32 grads, each divided by ``n_micro``.
    ``grad_shardings``: an optional tree of ``NamedSharding`` (the params')
    on which the accumulators are placed (``runtime/pspec.place``); the
    optimizer gets them back as full tensors where the parameters are
    plain tensors.
    """
    def train_step(params, opt_state, batch):
        if n_micro == 1:
            (loss, metrics), grads = grads_of(params, batch, cfg)
        else:
            def split(x):
                b = x.shape[0]
                return x.reshape(n_micro, b // n_micro, *x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            acc = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            if grad_shardings is not None:
                acc = _place(acc, grad_shardings)
            div = None
            losses, mets = [], []
            for i in range(n_micro):
                (l, met), g = grads_of(params, {k: v[i] for k, v in
                                                micro.items()}, cfg)
                if div is None:
                    div = torch.tensor(float(n_micro), dtype=torch.float32,
                                       device=l.device)
                g = adamw.tree_map(lambda gi: gi.to(torch.float32) / div, g)
                if grad_shardings is not None:
                    g = _place(g, grad_shardings)
                acc = adamw.tree_map(torch.add, acc, g)
                losses.append(l)
                mets.append(met)
            grads = _gathered(acc, params)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        params, opt_state, opt_metrics = adamw.update(
            grads, opt_state, params, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    """``(params, batch) -> metrics`` ({"ce", "aux"}) without gradients."""

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return eval_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, token (B,1), cache, pos) -> logits, cache."""

    def serve_step(params, token, cache, pos):
        with torch.inference_mode():
            return D.forward_decode(params, token, cache, pos, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Prefill: the forward over a prompt, (params, tokens (B, S),
    extra_embeds=None) -> logits (B, S_total, V); the attention of the
    dense, vlm, moe, mla_moe and encdec families and of hybrid_ssm's shared
    block runs the ``flash_attention`` kernel, the rwkv family's time-mix
    ``gla_time_mix`` (hybrid_ssm's Mamba2 layers are torch ops, as the
    reference's are jnp)."""

    def prefill_step(params, tokens, extra_embeds=None):
        with torch.inference_mode():
            logits, _ = T.forward(params, tokens, cfg,
                                  extra_embeds=extra_embeds)
        return logits

    return prefill_step
