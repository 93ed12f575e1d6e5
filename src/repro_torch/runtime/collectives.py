"""Compressed collectives: error-feedback quantized gradient sync.

Port of ``src/repro/runtime/collectives.py``: JAX's ``shard_map``
collectives become ``torch.distributed`` collectives over a process group
(the "data" group of a ``DeviceMesh``).

The paper's thesis -- keep tensors entropy/precision-reduced while they move
through a bandwidth-limited channel -- applied to the DP gradient reduction:

  baseline  : all-reduce fp32          -> 8 B/param wire cost (2x traffic)
  compressed: reduce-scatter bf16 (2B) -> quantize int8+scale (1B, error
              feedback) -> all-gather int8  => ~3 B/param, 2.7x reduction

Error feedback keeps the quantization residual per shard and folds it into
the next step's gradient.  The arithmetic is the reference's bit for bit:
rounding half to even (``torch.round``) and IEEE float32 division by a
tensor divisor (a Python-scalar divisor is a reciprocal multiply on the
card).
"""

from __future__ import annotations

from functools import partial

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from repro_torch.runtime.sharding import P  # noqa: F401  (the data-axis
#   layout of the reference's stacked gradients, P("data"): here each rank
#   passes its own gradient instead)

_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 scalar tensor on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_ef(x, residual, eb: float):
    """Error-feedback int8 lattice quantization of a tensor.

    Returns (codes int8, new_residual).  |dequant - (x + residual)| <= eb
    wherever |x + residual| < 127 * 2eb; saturated mass stays in the
    residual and re-enters next step.
    """
    target = x.to(torch.float32) + residual
    step = _f32(2 * eb, target)
    q = torch.clamp(torch.round(target / step), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * step
    return q, target - deq


def dequantize(q, eb: float):
    return q.to(torch.float32) * _f32(2 * eb, q)


def compressed_psum_mean(g, group, residual, eb: float = 0.0):
    """Mean-reduce ``g`` over the ranks of ``group`` with a bf16
    reduce-scatter + int8 all-gather wire format.

    The int8 step uses a *dynamic per-shard scale* (max|shard|/127, shipped
    alongside the codes -- 4 B per shard) so the scheme is magnitude-free;
    ``eb`` > 0 optionally floors the scale.  Error feedback keeps what
    rounding drops.  g: this rank's f32/bf16 gradient (same shape on every
    member); residual: float32 of ``ceil(g.numel() / n)``.
    Returns (mean_g f32, new_residual)."""
    n = dist.get_world_size(group)
    flat = g.reshape(-1).to(torch.bfloat16)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    # phase 1: bf16 reduce-scatter (each member owns 1/n of the sum)
    mine = flat.new_empty(flat.numel() // n)
    _reduce_scatter(mine, flat, op=dist.ReduceOp.SUM, group=group)
    target = mine.to(torch.float32) / _f32(n, mine) + residual
    scale = torch.maximum(target.abs().max() / _f32(127.0, target),
                          _f32(eb, target))
    scale = torch.maximum(scale, _f32(1e-30, target))
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_res = target - q.to(torch.float32) * scale
    # phase 2: all-gather int8 codes + per-shard scales
    gathered = q.new_empty(n * q.numel())
    _all_gather(gathered, q, group=group)
    scales = scale.new_empty(n)
    _all_gather(scales, scale.reshape(1), group=group)
    out = gathered.to(torch.float32) * scales.repeat_interleave(q.numel())
    if pad:
        out = out[:-pad]
    return out.reshape(g.shape), new_res


def make_dp_gradient_sync(mesh, eb: float = 1e-6):
    """Returns (sync_fn, init_residuals) for explicit-DP training loops
    over ``mesh``'s "data" group.

    sync_fn(grads, residuals) -> (mean_grads, residuals); grads is a pytree
    of this rank's *local* gradients, and each residual is
    ``ceil(size / n)`` float32 values (the reference's stacked residuals
    hold one such row a member).
    """
    group = mesh.get_group("data")
    n = dist.get_world_size(group)
    sync_one = partial(compressed_psum_mean, group=group, eb=eb)

    def init_residuals(grads):
        return pytree.tree_map(
            lambda g: torch.zeros(-(-g.numel() // n), dtype=torch.float32,
                                  device=g.device), grads)

    def sync(grads, residuals):
        leaves, tdef = pytree.tree_flatten(grads)
        pairs = [sync_one(g, residual=r) for g, r in
                 zip(leaves, pytree.tree_leaves(residuals))]
        return (pytree.tree_unflatten([o for o, _ in pairs], tdef),
                pytree.tree_unflatten([r for _, r in pairs], tdef))

    return sync, init_residuals


def wire_bytes(n_params: int, scheme: str) -> int:
    """Analytic per-step DP wire traffic per member (ring algorithms)."""
    if scheme == "allreduce_f32":
        return 2 * 4 * n_params          # reduce-scatter + all-gather, fp32
    if scheme == "allreduce_bf16":
        return 2 * 2 * n_params
    if scheme == "rs_bf16_ag_int8":
        return 2 * n_params + 1 * n_params
    raise ValueError(scheme)
