"""RWKV-6 time-mix recurrence (GLA): the CUDA wrapper and its plain version.

Port of ``src/repro/kernels/rwkv_gla.py:gla_time_mix``, the TPU replacement
of the per-step recurrence inside ``models/rwkv.py:time_mix``
(``csrc/gla_time_mix.cu``: the ``(dk, dv)`` state of each ``(b, h)`` row
spread over blocks of 16 columns and over the lanes of a warp, up to 8
rows a lane, in registers; each block loops over the sequence).  For head row
``bh``::

    y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t

Two differences from the Pallas kernel, which ``time_mix`` needs: the state
comes in (``None``: zero) and goes out, and ``u`` is per head, ``(H, dk)``,
row ``bh`` using ``u[bh % H]`` (the ``(B, H)`` layout flattened, b-major).
With a zero state in, ``u`` of shape ``(BH, dk)`` and the state out dropped,
it is the reference's ``gla_time_mix``.

The wrapper follows the port's rules: input checks, the kernel for CUDA
tensors, the plain version for CPU tensors, and each launch is counted
(``kernels/launches``).  ``meta`` tensors launch nothing: the wrapper
notes the launch's FLOPs and bytes with the active cost model
(``kernels/cost.note``) and returns empty outputs of the kernel's shapes
and types.  Any other device raises.

``gla_time_mix_trainable`` is the training counterpart: a
``torch.autograd.Function`` whose forward runs ``gla_time_mix`` one chunk
of ``CHUNK`` steps at a time with the state carried through, keeping the
state at each chunk boundary, and whose backward takes the chunks in
reverse, recomputing each one's states from its boundary state: the
memory profile of the reference's checkpointed chunk scan
(``models/rwkv.py`` ``time_mix``, whose backward is XLA autodiff), with
the recurrence's gradient derived by hand in torch ops
(``_chunk_backward``).  The tests hold it against autograd through
``gla_time_mix_plain`` and ``jax.grad`` through the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import launches

#: Largest ``dk`` and ``dv`` the kernel takes.
MAX_DK = 64
MAX_DV = 256


def _check(r, k, v, w, u, state):
    for name, t in (("r", r), ("k", k), ("w", w), ("v", v), ("u", u)):
        K._expect(name, t, torch.float32)
    if r.ndim != 3:
        raise ValueError(f"r must be (BH, S, dk), got shape "
                         f"{tuple(r.shape)}")
    bh, s, dk = r.shape
    K._expect("k", k, torch.float32, r.shape)
    K._expect("w", w, torch.float32, r.shape)
    if v.ndim != 3 or v.shape[:2] != (bh, s):
        raise ValueError(f"v must be (BH, S, dv) = ({bh}, {s}, dv), got "
                         f"shape {tuple(v.shape)}")
    dv = v.shape[2]
    if u.ndim != 2 or u.shape[1] != dk or u.shape[0] < 1 or bh % u.shape[0]:
        raise ValueError(f"u must be (H, dk) with BH % H == 0, got shape "
                         f"{tuple(u.shape)} for BH {bh}, dk {dk}")
    if state is not None:
        K._expect("state", state, torch.float32, (bh, dk, dv))
    if min(bh, s) < 1 or not (1 <= dk <= MAX_DK and 1 <= dv <= MAX_DV):
        raise ValueError(f"gla_time_mix takes BH, S >= 1, dk <= {MAX_DK} "
                         f"and dv <= {MAX_DV}, got r {tuple(r.shape)}, v "
                         f"{tuple(v.shape)}")
    if max(r.numel(), v.numel()) >= 1 << 31:
        raise ValueError("gla_time_mix takes fewer than 2**31 values a "
                         "tensor")
    tensors = [r, k, v, w, u] + ([state] if state is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel and no plain path for device "
                         f"{r.device}")


def gla_time_mix_plain(r, k, v, w, u, state=None):
    """Plain version of :func:`gla_time_mix` (any device): the per-step
    recurrence in float32, state in and out."""
    bh, s, dk = r.shape
    uu = u.repeat(bh // u.shape[0], 1)[:, :, None]
    st = (torch.zeros((bh, dk, v.shape[2]), dtype=torch.float32,
                      device=r.device) if state is None else state.clone())
    ys = []
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append((r[:, t, :, None] * (st + uu * kv)).sum(1))
        st = w[:, t, :, None] * st + kv
    return torch.stack(ys, 1), st


@launches.counted
def gla_time_mix(r, k, v, w, u, state=None):
    """The RWKV-6 recurrence over ``S`` steps for every head row.

    ``r``, ``k``, ``w``: float32 (BH, S, dk); ``v``: float32 (BH, S, dv);
    ``u``: float32 (H, dk), BH % H == 0; ``state``: float32 (BH, dk, dv) or
    ``None`` (zero).  All contiguous.  Returns ``(y (BH, S, dv), state
    (BH, dk, dv))``, both float32 and new tensors.
    """
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return gla_time_mix_plain(r, k, v, w, u, state)
    bh, s, dk = r.shape
    dv = v.shape[2]
    y = torch.empty((bh, s, dv), dtype=torch.float32, device=r.device)
    state_out = torch.empty((bh, dk, dv), dtype=torch.float32,
                            device=r.device)
    if r.device.type == "meta":
        cost.note("gla_time_mix", *cost.gla_time_mix_cost(
            r, k, v, w, u, state, y, state_out))
        return y, state_out
    launch = _build.load("gla_time_mix")
    rc = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if state is None else state.data_ptr(),
                y.data_ptr(), state_out.data_ptr(), bh, s, dk, dv,
                u.shape[0], K._stream_ptr(r.device))
    if rc != 0:
        raise RuntimeError(f"gla_time_mix kernel launch failed: CUDA error "
                           f"{rc}")
    launches.launched(gla_time_mix)
    return y, state_out


#: Steps a chunk of ``gla_time_mix_trainable``: the reference's ``chunk``.
CHUNK = 64


class _GLATimeMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        s = r.shape[1]
        ys, starts = [], []
        st = state
        for lo in range(0, s, chunk):
            hi = min(lo + chunk, s)
            starts.append(st)
            y, st = gla_time_mix(*(t[:, lo:hi].contiguous()
                                   for t in (r, k, v, w)), u, st)
            ys.append(y)
        boundaries = [torch.zeros((r.shape[0], r.shape[2], v.shape[2]),
                                  dtype=torch.float32, device=r.device)
                      if b is None else b for b in starts]
        ctx.save_for_backward(r, k, v, w, u, *boundaries)
        ctx.chunk = chunk
        ctx.has_state = state is not None
        return torch.cat(ys, 1), st

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, *boundaries = ctx.saved_tensors
        chunk = ctx.chunk
        u_rows = u.repeat(r.shape[0] // u.shape[0], 1)
        grads = [torch.empty_like(t) for t in (r, k, v, w)]
        du_rows = torch.zeros_like(u_rows)
        carry = dstate
        for i in reversed(range(len(boundaries))):
            lo = i * chunk
            hi = min(lo + chunk, r.shape[1])
            *pieces, du, carry = _chunk_backward(
                *(t[:, lo:hi] for t in (r, k, v, w, dy)), u_rows,
                boundaries[i], carry)
            for g, piece in zip(grads, pieces):
                g[:, lo:hi] = piece
            du_rows += du
        du = du_rows.reshape(-1, *u.shape).sum(0)
        return (*grads, du, carry if ctx.has_state else None, None)


def _chunk_backward(r, k, v, w, dy, u_rows, state, dstate):
    """The recurrence's reverse over one chunk, in torch ops: ``(dr, dk,
    dv, dw, du per row, dstate in)`` from ``dy`` and ``dstate`` (the
    gradient of the state after the chunk), ``state`` the state before it.

    With ``S_t = w_t S_{t-1} + k_t v_t^T`` and ``y_t = r_t (S_{t-1} + u
    k_t v_t^T)``, the state's gradient runs back as ``G_{t-1} = w_t G_t +
    r_t dy_t^T`` (``G_t`` that of ``S_t``); then, for every step at once,
    ``dr = S_{t-1} dy + u k (v . dy)``, ``dk = G_t v + r u (v . dy)``,
    ``dv = G_t^T k + (r . u k) dy``, ``dw = rowsum(G_t * S_{t-1})``, ``du =
    sum_t r k (v . dy)``.  Two sequential ops a step (the forward's states
    again, then ``G``); the rest is batched over the chunk."""
    kv = k[..., :, None] * v[..., None, :]             # (BH, c, dk, dv)
    prev = torch.empty_like(kv)                        # S_{t-1}
    st = state
    for t in range(r.shape[1]):
        prev[:, t] = st
        st = torch.addcmul(kv[:, t], w[:, t, :, None], st)
    del kv
    grad = r[..., :, None] * dy[..., None, :]          # r_t dy_t^T, then G_t
    carry = dstate
    for t in reversed(range(r.shape[1])):
        rdy = grad[:, t].clone()
        grad[:, t] = carry
        carry = torch.addcmul(rdy, w[:, t, :, None], carry)
    vdy = (v * dy).sum(-1, keepdim=True)               # (BH, c, 1)
    uk = u_rows[:, None, :] * k
    dr = torch.einsum("btij,btj->bti", prev, dy) + uk * vdy
    dk = torch.einsum("btij,btj->bti", grad, v) + r * u_rows[:, None] * vdy
    dv = torch.einsum("bti,btij->btj", k, grad) + (r * uk).sum(
        -1, keepdim=True) * dy
    dw = (grad * prev).sum(-1)
    du = (r * k * vdy).sum(1)
    return dr, dk, dv, dw, du, carry


def gla_time_mix_trainable(r, k, v, w, u, state=None, chunk: int = CHUNK):
    """Differentiable :func:`gla_time_mix` (same arguments and results):
    gradients for ``r``, ``k``, ``v``, ``w``, ``u`` (summed over the batch
    rows that share a head) and the state in, from the gradients of ``y``
    and of the state out.  Saves the inputs and one state a ``chunk``
    steps; the backward holds one chunk's states and state gradients at
    a time."""
    return _GLATimeMix.apply(r, k, v, w, u, state, int(chunk))
