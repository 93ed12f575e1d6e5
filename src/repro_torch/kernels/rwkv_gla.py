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
tensors, the plain version for CPU tensors, any other device raises, and
each launch is counted (``kernels/launches``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
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
    if r.device.type not in ("cpu", "cuda"):
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
