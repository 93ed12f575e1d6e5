"""Flash-attention forward: the CUDA wrapper and its plain version.

Port of ``src/repro/kernels/flash_attn.py:flash_attention``, the TPU
replacement of the blockwise attention ``models/attention.py:blockwise_attn``
(``csrc/flash_attn.cu``: one block a 64-row query tile, the online
softmax's ``(m, l, acc)`` in registers across the kv loop, tiles above the
causal diagonal and tiles wholly below a sliding window skipped).  The
kernel chooses by dtype: bfloat16 runs on the tensor cores (``mma.sync``
bf16 tiles, double-buffered ``cp.async`` K and V, p rounded to bf16 for
the P V product; D up to 192 and Dv up to 128, padded to the template
widths), float32 runs scalar float32 FMAs.  Beyond the Pallas kernel it
takes any ``Sq`` and ``Skv`` (the ragged last tiles are masked), a
``scale`` (default ``D ** -0.5``; the model passes a pre-scaled ``q`` with
``scale=1.0``, as
the reference's model scales ``q`` in its working type) and GQA: ``q`` has
``groups`` times the rows of ``k`` and ``v``, and query row ``bh`` reads kv
row ``bh // groups`` (the ``(B, H, S, D)`` layout flattened, b-major).
Beyond the Pallas kernel too, it takes the two masking arguments of the
reference's XLA ``blockwise_attn``: ``window`` (sliding-window attention)
and ``q_offset`` (the absolute position of query 0 against key 0); see
:func:`flash_attention` for the rule.

The wrapper follows the port's rules: input checks, the kernel for CUDA
tensors, the plain version for CPU tensors, and each launch is counted
(``kernels/launches``).  ``meta`` tensors launch nothing: the wrapper
notes the launch's FLOPs and bytes with the active cost model
(``kernels/cost.note``, read by ``launch/hlo_cost.py``) and returns an
empty output of the kernel's shape and type.  Any other device raises.

``flash_attention_trainable`` is the training counterpart (reference
``flash_attention_trainable``, a Pallas forward with a recomputed XLA
backward): a ``torch.autograd.Function`` whose forward is
``flash_attention`` (the kernel for CUDA tensors) and whose backward
recomputes the softmax from the saved ``q, k, v`` in float32 torch ops,
one query chunk at a time.  ``dense_attention`` is the reference's
``_xla_attention``, the oracle of the tests.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

NEG_INF = -1e30
#: Largest query/key head ``D`` the kernel takes (192: multi-head latent
#: attention's qk_nope 128 + qk_rope 64).
MAX_HEAD_DIM = 192
#: Largest value head ``Dv`` the kernel takes.
MAX_V_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        K._expect(name, t, q.dtype)
        if t.ndim != 3:
            raise ValueError(f"{name} must be (BH, S, D), got shape "
                             f"{tuple(t.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    bh, sq, d = q.shape
    bkv, skv, dk = k.shape
    if v.shape[:2] != (bkv, skv) or dk != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    dv = v.shape[2]
    if min(bh, sq, bkv, skv) < 1 or bh % bkv:
        raise ValueError(f"flash_attention needs non-empty q, k, v and "
                         f"BH % BHkv == 0, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a query/key head D up to "
                         f"{MAX_HEAD_DIM}, got D {d}")
    if not 1 <= dv <= MAX_V_HEAD_DIM:
        raise ValueError(f"flash_attention takes a value head Dv up to "
                         f"{MAX_V_HEAD_DIM}, got Dv {dv}")
    if max(q.numel(), v.numel() // bkv * bh) >= 1 << 31:
        raise ValueError("flash_attention takes fewer than 2**31 values a "
                         "tensor")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{q.device}")
    return bh // bkv


def _check_mask(sq, skv, causal, window, q_offset):
    """Validate ``window`` and ``q_offset`` and return the window the
    kernel takes (0 for none).  Raises ``ValueError`` for a query row that
    sees no key: the reference gives such a row the mean of ``v`` over
    the masked keys (its mask is a finite -1e30), a value no caller of it
    makes, so the kernel refuses those shapes instead of matching it."""
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be a positive int or None, got "
                         f"{window!r}")
    if int(q_offset) != q_offset or not (
            -(1 << 30) < q_offset and q_offset + sq < 1 << 30):
        raise ValueError(f"q_offset must be an int with |q_offset| and "
                         f"q_offset + Sq below 2**30, got {q_offset!r}")
    # lo and hi of the visible keys grow with the query's position, so
    # only the first and the last row can see none
    for qpos in (q_offset, q_offset + sq - 1):
        lo = 0 if window is None else max(0, qpos - window + 1)
        hi = min(skv - 1, qpos) if causal else skv - 1
        if lo > hi:
            raise ValueError(
                f"query position {qpos} sees no key (Skv {skv}, causal "
                f"{causal}, window {window}, q_offset {q_offset}): "
                f"flash_attention takes no fully masked row")
    if window is None:
        return 0
    # past every query's distance to key 0 a window masks nothing: cap it
    # there, which keeps the kernel's position arithmetic inside int32
    return int(min(window, max(1, q_offset + sq)))


def visible_mask(sq: int, skv: int, *, causal: bool, window=None,
                 q_offset: int = 0, device=None):
    """The (Sq, Skv) bool mask of the keys each query sees, or None when
    every key is seen: key ``j`` is seen by query ``i`` (absolute position
    ``qpos = q_offset + i``) when ``j <= qpos`` if ``causal`` and ``j >
    qpos - window`` if a window is given (the reference's
    ``blockwise_attn`` mask)."""
    if not causal and window is None:
        return None
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None, window=None,
                          q_offset: int = 0):
    """Plain version of :func:`flash_attention` (any device): the dense
    masked softmax in float32 from the same inputs, ``q`` scaled in float32
    first (the float32 kernel does so; the bf16 kernel scales the scores),
    cast once to ``q``'s type.  Masked scores are the reference's finite
    -1e30, so a row that sees no key gets the mean of ``v``, as the
    reference's does."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    groups = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(groups, 0)
    vf = v.float().repeat_interleave(groups, 0)
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, kf)
    mask = visible_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                        q_offset=q_offset, device=q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), vf).to(q.dtype)


@launches.counted
def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window=None,
                    q_offset: int = 0):
    """Softmax attention of ``q`` (BH, Sq, D) over ``k`` (BH / G, Skv, D)
    and ``v`` (BH / G, Skv, Dv); returns (BH, Sq, Dv) in ``q``'s type.

    Query ``i`` sits at absolute position ``qpos = q_offset + i`` (key
    ``j`` at ``j``) and sees key ``j`` when ``j <= qpos`` if ``causal``
    (with ``q_offset`` 0, top-left aligned, as the Pallas kernel masks) and
    ``j > qpos - window`` if ``window`` is given: the reference's
    ``blockwise_attn`` rule.  A shape in which some query row sees no key
    raises ``ValueError`` (the reference would give it the mean of ``v``;
    no caller makes one).  ``q``, ``k``, ``v``: float32 or bfloat16 alike,
    contiguous, D at most ``MAX_HEAD_DIM`` and Dv at most
    ``MAX_V_HEAD_DIM``.
    """
    groups = _check(q, k, v)
    bh, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[2]
    kwin = _check_mask(sq, skv, causal, window, q_offset)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, q_offset=q_offset)
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        cost.note("flash_attention", *cost.flash_attention_cost(
            q, k, v, out, causal, window, q_offset))
        return out
    launch = _build.load("flash_attn")
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, groups, sq, skv, d, dv, int(causal), kwin,
                int(q_offset), scale, int(q.dtype == torch.bfloat16),
                K._stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches.launched(flash_attention)
    return out


def dense_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    window=None, q_offset: int = 0):
    """The reference's ``_xla_attention`` in torch ops (differentiable):
    float32 scores of ``q`` and ``k`` times ``scale`` (default ``D **
    -0.5``), the mask (causal, and the window and ``q_offset`` of
    :func:`flash_attention`), softmax, ``p @ v``, cast to ``q``'s type.
    GQA as :func:`flash_attention` takes it."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    groups = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(groups, 0)
    vf = v.float().repeat_interleave(groups, 0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kf) * scale
    mask = visible_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                        q_offset=q_offset, device=q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), vf).to(q.dtype)


def attention_backward(q, k, v, do, *, causal: bool, scale: float,
                       chunk: int = 512, window=None, q_offset: int = 0):
    """``(dq, dk, dv)`` of softmax attention at ``q`` (BH, Sq, D), ``k`` (BH
    / G, Skv, D), ``v`` (BH / G, Skv, Dv) for the output gradient ``do``
    (BH, Sq, Dv), each in its input's type; masked as
    :func:`flash_attention` masks (``causal``, ``window``, ``q_offset``).

    The softmax is recomputed from ``q`` and ``k`` in float32, ``chunk``
    query rows at a time, so at most ``(BH, chunk, Skv)`` scores live at
    once (the reference's checkpointed query chunk).  Query row ``bh``
    reads kv row ``bh // G``, so ``dk`` and ``dv`` sum over each group."""
    bh, sq, d = q.shape
    bkv, skv, dv_ = v.shape
    g = bh // bkv
    qf = q.float().reshape(bkv, g, sq, d)
    dof = do.float().reshape(bkv, g, sq, dv_)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    kpos = torch.arange(skv, device=q.device)
    for lo in range(0, sq, chunk):
        n = min(chunk, sq - lo)
        # a kv row's g query rows of the chunk as one (g * n)-row matrix
        qs = (qf[:, :, lo:lo + n] * scale).reshape(bkv, g * n, d)
        doc = dof[:, :, lo:lo + n].reshape(bkv, g * n, dv_)
        s = qs @ kf.transpose(1, 2)
        qpos = (q_offset + lo + torch.arange(g * n, device=q.device)
                % n)[:, None]
        if causal:
            s.masked_fill_(kpos[None, :] > qpos, NEG_INF)
        if window is not None:
            s.masked_fill_(kpos[None, :] <= qpos - window, NEG_INF)
        p = torch.softmax(s, -1)
        del s
        dv += p.transpose(1, 2) @ doc
        # ds = p * (dp - rowsum(dp * p)), in place on dp
        ds = doc @ vf.transpose(1, 2)
        ds.sub_((ds * p).sum(-1, keepdim=True)).mul_(p)
        del p
        dq[:, :, lo:lo + n] = (ds @ kf).reshape(bkv, g, n, d) * scale
        dk += ds.transpose(1, 2) @ qs
        del ds
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, chunk, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.chunk = causal, scale, chunk
        ctx.window, ctx.q_offset = window, q_offset
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window, q_offset=q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(
            q, k, v, do, causal=ctx.causal, scale=ctx.scale, chunk=ctx.chunk,
            window=ctx.window, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = True,
                              scale: float | None = None, chunk: int = 512,
                              window=None, q_offset: int = 0):
    """Differentiable :func:`flash_attention`: the kernel forward (the plain
    version for CPU tensors) and a recomputed torch-ops backward
    (:func:`attention_backward`, ``chunk`` query rows at a time), both
    masked by ``causal``, ``window`` and ``q_offset``.  Saves only ``q``,
    ``k`` and ``v``: no score block outlives the forward."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, bool(causal), scale, int(chunk),
                                 window, int(q_offset))
