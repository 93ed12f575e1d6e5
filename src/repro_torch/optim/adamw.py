"""Functional AdamW with optional int8 block-quantized state.

Port of ``src/repro/optim/adamw.py``.  The int8 path stores m and v as
int8 with per-block (128) float32 scales -- ~4.25 bytes/param of optimizer
state instead of 8: bounded-error quantization of a tensor whose consumer
tolerates noise, the paper's trick applied to optimizer state.

The trees follow the parameters' structure (dicts and the port's list of
layers); an int8 state leaf is a dict, ``{"q", "scale"}`` or ``{"f"}``,
where the parameter has a tensor.  Nothing here writes to the caller's
tensors: ``update`` returns new ones.

Rounding is the reference's, operation for operation, so that given the
same gradients the int8 ``q`` comes out bit for bit: every divisor is a
float32 tensor (a Python-scalar divisor is a reciprocal multiply on the
card), Python-scalar factors are float32 as JAX's weak types are, and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import torch

BLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # "float32" | "int8"


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _quantizable(shape) -> bool:
    if len(shape) == 0:
        return False
    return shape[-1] % BLOCK == 0


def quantize_state(x):
    """int8 state, blocked along the LAST dim, kept in the param's shape.

    Non-conforming leaves (tiny / last dim not a multiple of 128) stay
    float32 under the "f" key.
    """
    if not _quantizable(x.shape):
        return {"f": x.to(torch.float32)}
    nb = x.shape[-1] // BLOCK
    blocks = x.reshape(*x.shape[:-1], nb, BLOCK)
    scale = blocks.abs().amax(dim=-1) / _f32(127.0, x)          # (..., nb)
    scale = scale.clamp(min=1e-12)
    q = torch.round(blocks / scale[..., None]).clamp(-127, 127).to(
        torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale.to(torch.float32)}


def dequantize_state(s, shape):
    if "f" in s:
        return s["f"]
    nb = shape[-1] // BLOCK
    q = s["q"].reshape(*shape[:-1], nb, BLOCK)
    return (q.to(torch.float32) * s["scale"][..., None]).reshape(shape)


def tree_map(fn, tree, *others):
    """``fn`` over the leaves of ``tree`` (dicts and lists), with the
    matching subtrees of ``others``: a leaf of ``tree`` receives whatever
    ``others`` hold at its place (an int8 state dict included)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(o[i] for o in others))
                for i, v in enumerate(tree)]
    return fn(tree, *others)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` (dicts and lists) in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def init(params, cfg: AdamWConfig):
    def zeros_like_state(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.state_dtype == "int8":
            return quantize_state(z)
        return z

    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros_like_state, params),
        "v": tree_map(zeros_like_state, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(grads, opt_state, params, cfg: AdamWConfig):
    """One AdamW step: ``(new params, new state, {"grad_norm"})``, the norm
    taken before the clip.  New tensors; the arguments are not written."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(_f32(cfg.grad_clip, gnorm)
                       / gnorm.clamp(min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        if cfg.state_dtype == "int8":
            m_f = dequantize_state(m, p.shape)
            v_f = dequantize_state(v, p.shape)
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        mhat = m_f / bc1
        vhat = v_f / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - cfg.lr * delta).to(p.dtype)
        if cfg.state_dtype == "int8":
            return new_p, quantize_state(m_f), quantize_state(v_f)
        return new_p, m_f, v_f

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        if isinstance(tree, list):
            return [pick(v, i) for v in tree]
        return tree[i]

    new_p, new_m, new_v = (pick(out, i) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm}
