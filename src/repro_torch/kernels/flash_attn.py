"""Flash-attention forward: the CUDA wrapper and its plain version.

Port of ``src/repro/kernels/flash_attn.py:flash_attention``, the TPU
replacement of the blockwise attention ``models/attention.py:blockwise_attn``
(``csrc/flash_attn.cu``: one block a 64-row query tile, the online
softmax's ``(m, l, acc)`` in registers across the kv loop, tiles above the
causal diagonal skipped).  The kernel chooses by dtype: bfloat16 runs on the
tensor cores (``mma.sync`` bf16 tiles, double-buffered ``cp.async`` K and
V, p rounded to bf16 for the P V product), float32 runs scalar float32
FMAs.  Beyond the Pallas kernel it takes any ``Sq`` and
``Skv`` (the ragged last tiles are masked), a ``scale`` (default
``D ** -0.5``; the model passes a pre-scaled ``q`` with ``scale=1.0``, as
the reference's model scales ``q`` in its working type) and GQA: ``q`` has
``groups`` times the rows of ``k`` and ``v``, and query row ``bh`` reads kv
row ``bh // groups`` (the ``(B, H, S, D)`` layout flattened, b-major).

The wrapper follows the port's rules: input checks, the kernel for CUDA
tensors, the plain version for CPU tensors, any other device raises, and
each launch is counted (``kernels/launches``).  The backward of
``flash_attention_trainable`` comes with training (ROADMAP A10).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

NEG_INF = -1e30
#: Largest ``D`` and ``Dv`` the kernel takes.
MAX_HEAD_DIM = 128
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
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention takes D and Dv up to "
                         f"{MAX_HEAD_DIM}, got {d} and {dv}")
    if max(q.numel(), v.numel() // bkv * bh) >= 1 << 31:
        raise ValueError("flash_attention takes fewer than 2**31 values a "
                         "tensor")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{q.device}")
    return bh // bkv


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """Plain version of :func:`flash_attention` (any device): the dense
    masked softmax in float32 from the same inputs, ``q`` scaled in float32
    first (the float32 kernel does so; the bf16 kernel scales the scores),
    cast once to ``q``'s type."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    groups = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(groups, 0)
    vf = v.float().repeat_interleave(groups, 0)
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, kf)
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), vf).to(q.dtype)


@launches.counted
def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Softmax attention of ``q`` (BH, Sq, D) over ``k`` (BH / G, Skv, D)
    and ``v`` (BH / G, Skv, Dv); returns (BH, Sq, Dv) in ``q``'s type.

    ``causal`` masks key ``j`` from query ``i`` when ``j > i`` (top-left
    aligned, as the Pallas kernel masks).  ``q``, ``k``, ``v``: float32 or
    bfloat16 alike, contiguous, D and Dv at most ``MAX_HEAD_DIM``.
    """
    groups = _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    bh, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[2]
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    launch = _build.load("flash_attn")
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, groups, sq, skv, d, dv, int(causal), scale,
                int(q.dtype == torch.bfloat16), K._stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches.launched(flash_attention)
    return out
