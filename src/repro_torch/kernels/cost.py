"""What a model kernel costs: its FLOPs, its bytes and its bound on the card.

One home for the formulas that ``chip_smoke.py`` bounds the model kernels
by and that the meta-device cost model (``launch/hlo_cost.py``) counts
them by, so the two never part:

  * :func:`flash_pairs` -- the (query, key) pairs ``flash_attention``'s
    mask keeps;
  * :func:`flash_attention_cost` -- 2 (D + Dv) FLOP a kept pair a head
    row, and the bytes of q, k, v and the output;
  * :func:`gla_time_mix_cost` -- 7 float32 FLOP a state element a step
    (k v, u (k v) + S, r (...) summed, w S + k v), and the bytes of the
    inputs and outputs;
  * :func:`model_kernel_bound` -- the larger of the bytes at the HBM rate
    and the FLOPs at the card's peak for their type, in ms.

A kernel wrapper given ``meta`` tensors launches nothing: it hands its
cost to :func:`note`, which passes it to every recorder that
:func:`recording` made active (``hlo_cost.StepCost``), and returns empty
outputs of the kernel's shapes and dtypes.  The train step names its
gradients through :func:`derived`, so that the recorder can weigh them by
the parameter each belongs to.
"""

from __future__ import annotations

import contextlib

import numpy as np

#: Published HBM3 bandwidth of the H100 SXM (bytes/s), for the byte bounds.
HBM_BYTES_PER_S = 3.35e12
#: Published dense peaks of the H100 SXM by input type (FLOP/s): bf16 on
#: the tensor cores, float32 without them.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

_recorders: list = []


@contextlib.contextmanager
def recording(recorder):
    """Make ``recorder`` (an object with ``note_kernel(name, flops,
    nbytes)`` and ``note_derived(tree, like)`` methods) receive every
    :func:`note` and :func:`derived` inside the block."""
    _recorders.append(recorder)
    try:
        yield recorder
    finally:
        _recorders.remove(recorder)


def note(name: str, flops: float, nbytes: float) -> None:
    """One launch of kernel ``name`` doing ``flops`` and moving ``nbytes``,
    handed to the active recorders (none: nothing happens)."""
    for r in _recorders:
        r.note_kernel(name, flops, nbytes)


def derived(tree, like) -> None:
    """The tensors of ``tree`` are each made for the parameter in its place
    in ``like`` (its gradient, an accumulator of it): a recorder that
    shares storages out by parameter gives each that parameter's share."""
    for r in _recorders:
        r.note_derived(tree, like)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def flash_pairs(sq: int, skv: int, causal: bool = True, window=None,
                q_offset: int = 0) -> int:
    """The (query, key) pairs ``flash_attention``'s mask keeps: for query
    position ``p = q_offset + i``, keys ``max(0, p - window + 1)`` to
    ``min(skv - 1, p)`` (causal) or ``skv - 1``."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.zeros_like(p) if window is None else np.maximum(0, p - window + 1)
    hi = np.minimum(skv - 1, p) if causal else np.full_like(p, skv - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_attention_cost(q, k, v, out, causal: bool = True, window=None,
                         q_offset: int = 0) -> tuple:
    """``(flops, bytes)`` of one ``flash_attention`` launch: 2 (D + Dv)
    FLOP for each kept (query, key) pair of each head row, and each of q,
    k, v read once and the output written once."""
    bh, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[2]
    pairs = flash_pairs(sq, skv, causal, window, q_offset)
    return 2 * bh * pairs * (d + dv), _nbytes((q, k, v, out))


def gla_time_mix_cost(r, k, v, w, u, state, y, state_out) -> tuple:
    """``(flops, bytes)`` of one ``gla_time_mix`` launch: 7 float32 FLOP a
    state element a step, and each input read once and each output
    written once."""
    bh, s, dk = r.shape
    return (7 * bh * s * dk * v.shape[2],
            _nbytes((r, k, v, w, u, state, y, state_out)))


def model_kernel_bound(kname: str, args, out, mask=None) -> tuple:
    """``(bound_ms, bound_by)`` of one launch at these inputs: the larger of
    the bytes (each input read once, each output written once) at the HBM
    rate and the operations at the card's peak for their type.  flash:
    ``args`` (q, k, v), ``mask`` the causal, window and q_offset keywords
    (causal alone by default), at the bf16 tensor-core peak for bf16
    inputs; gla: ``args`` (r, k, v, w, u[, state]), ``out`` (y, state),
    at the float32 peak."""
    if kname == "flash_attention":
        q, k, v = args
        mask = {"causal": True} if mask is None else mask
        flops, nbytes = flash_attention_cost(q, k, v, out[0], **{
            key: mask[key] for key in ("causal", "window", "q_offset")
            if key in mask})
        ops_s = flops / PEAK_FLOPS[dtype_name(q)]
    else:
        r, k, v, w, u = args[:5]
        state = args[5] if len(args) > 5 else None
        flops, nbytes = gla_time_mix_cost(r, k, v, w, u, state, *out)
        ops_s = flops / PEAK_FLOPS[dtype_name(r)]
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s
                                       else "operations")
