"""Mamba2 (SSD) blocks -- chunked state-space duality formulation.

Port of ``src/repro/models/ssm.py``.  The reference's ``ssd_scan`` is jnp,
outside any Pallas kernel, so its port is torch ops: the products run as
``torch.matmul`` (batched GEMMs), the rest elementwise, all in float32.
The reference's three-operand ``einsum``s are written as two two-operand
contractions each (the same sums, grouped differently in float32), and its
``lax.scan`` over chunk states as a loop over the chunks in the scan's
order.

The scalar-per-head decay makes the chunked algorithm numerically safe: all
pairwise decay factors are exp(cumA_t - cumA_s) <= 1 for t >= s, so the
(Q, Q) intra-chunk matrices never overflow (unlike per-channel-decay models,
see rwkv.py).  Structure follows the Mamba2 paper's reference:

  intra:  Y[t] += sum_{s<=t in chunk} (C_t . B_s) * exp(A[s+1..t]) * X[s]
  state:  S_c   = sum_{s in chunk} exp(A[s+1..end]) * B_s (x) X_s
  inter:  Y[t] += C_t . (decay * S_{c-1}) * exp(A[chunk_start..t])

Decode keeps the (B, H, N, P) float32 recurrent state:
h = dA*h + dt*x (x) B.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def ssm_dims(cfg: ModelConfig):
    p_head = 64
    dv = 2 * cfg.d_model                      # expand factor 2
    h = cfg.ssm_heads if cfg.ssm_heads else dv // p_head
    p_head = dv // h
    return dv, h, p_head


def init_ssm(gen, cfg: ModelConfig):
    d = cfg.d_model
    n = cfg.ssm_state
    dv, h, _p = ssm_dims(cfg)
    return {
        # fused in-projection: [x (dv) | z (dv) | B (n) | C (n) | dt (h)]
        "win": L.dense_init(gen, (d, 2 * dv + 2 * n + h), cfg.pdt),
        "wout": L.dense_init(gen, (dv, d), cfg.pdt),
        "a_log": L.full(gen, (h,), 0.0, torch.float32),   # A = -exp(a_log)
        "d_skip": L.full(gen, (h,), 1.0, torch.float32),
        "dt_bias": L.full(gen, (h,), 0.0, torch.float32),
        "norm": L.full(gen, (dv,), 1.0, cfg.pdt),
    }


def _segsum(a):
    """Lower-triangular pairwise sums: out[t, s] = sum_{s < u <= t} a[u],
    -inf above the diagonal (``exp`` of it is 0, with a zero gradient)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, -torch.inf)


def _softplus(x):
    """``jax.nn.softplus``: ``log(1 + exp(x))`` as ``logaddexp(x, 0)``, with
    no linear cut-off (``F.softplus`` returns ``x`` past 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk clamp: ``chunk`` capped at ``s``, then halved
    until it divides ``s`` (an odd ``s`` past ``chunk`` gives chunks of
    1)."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    return chunk


def ssd_scan(x, b_in, c_in, dt, a, chunk: int):
    """Chunked SSD.

    x:  (B, S, H, P)   values
    b_in, c_in: (B, S, N)  input/output projections (shared across heads)
    dt: (B, S, H)      softplus'd step sizes
    a:  (H,)           negative decay rates
    Returns y: (B, S, H, P).
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q

    xs = x.reshape(bsz, nc, q, h, p)
    bs = b_in.reshape(bsz, nc, q, n)
    cs = c_in.reshape(bsz, nc, q, n)
    dts = dt.reshape(bsz, nc, q, h)
    da = (dts * a).transpose(-1, -2)                   # (B,nc,H,Q) log-decay

    # intra-chunk: scores[h, t, s] = (C_t . B_s) exp(segsum)[h, t, s]
    cb = cs @ bs.transpose(-1, -2)                     # (B,nc,Q,Q)
    scores = torch.exp(_segsum(da)) * cb[:, :, None]   # (B,nc,H,Q,Q)
    xdt = xs * dts[..., None]                          # (B,nc,Q,H,P)
    xdt_h = xdt.transpose(2, 3)                        # (B,nc,H,Q,P)
    y = (scores @ xdt_h).transpose(2, 3)               # (B,nc,Q,H,P)
    del scores

    # chunk states: S_c = sum_s exp(cum_end - cum_s) * dtB_s (x) X_s
    cum = torch.cumsum(da, dim=-1)                     # (B,nc,H,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)      # (B,nc,H,Q)
    w = xdt * decay_to_end.transpose(-1, -2)[..., None]   # (B,nc,Q,H,P)
    sstate = (bs.transpose(-1, -2) @ w.reshape(bsz, nc, q, h * p)).reshape(
        bsz, nc, n, h, p).permute(0, 1, 3, 2, 4)       # (B,nc,H,N,P)
    del w

    # inter-chunk recurrence over chunk states: the state entering each
    # chunk, recorded before its update (the reference's scan)
    chunk_decay = torch.exp(cum[..., -1])              # (B,nc,H)
    s_prev = torch.zeros_like(sstate[:, 0])
    prevs = []
    for c in range(nc):
        prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + sstate[:, c]
    del sstate, s_prev
    s_prevs = torch.stack(prevs, 1)                    # (B,nc,H,N,P)
    del prevs

    # inter-chunk contribution: C_t . S_prev, times exp(cum_t)
    decay_in = torch.exp(cum)                          # (B,nc,H,Q)
    ys = cs @ s_prevs.permute(0, 1, 3, 2, 4).reshape(bsz, nc, n, h * p)
    y_inter = ys.reshape(bsz, nc, q, h, p) * decay_in.transpose(
        -1, -2)[..., None]                             # (B,nc,Q,H,P)
    return (y + y_inter).reshape(bsz, s, h, p)


def _split_proj(proj, cfg: ModelConfig):
    n = cfg.ssm_state
    dv, h, _ = ssm_dims(cfg)
    return torch.split(proj, [dv, dv, n, n, h], dim=-1)


def ssm_block(x, p, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d)."""
    bsz, s, d = x.shape
    dv, h, ph = ssm_dims(cfg)
    proj = x @ p["win"].to(x.dtype)
    xv, z, b_in, c_in, dt = _split_proj(proj, cfg)
    dt = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    # one float32 copy of x for both uses, so that its two gradients sum
    # in float32 before the one cast back (XLA's, after CSE)
    xh = xv.reshape(bsz, s, h, ph).float()
    y = ssd_scan(xh, b_in.float(), c_in.float(), dt, a, cfg.ssm_chunk)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, dv).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"])
    return y @ p["wout"].to(x.dtype)


def ssm_decode(x, p, cfg: ModelConfig, state):
    """Single-token decode.  x: (B, 1, d); state: (B, H, N, P) float32.
    Returns (out (B, 1, d), the new state); ``state`` is not written."""
    bsz = x.shape[0]
    dv, h, ph = ssm_dims(cfg)
    proj = x[:, 0] @ p["win"].to(x.dtype)
    xv, z, b_in, c_in, dt = _split_proj(proj, cfg)
    dt = _softplus(dt.float() + p["dt_bias"])                     # (B,H)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)                                       # (B,H)
    xh = xv.reshape(bsz, h, ph).float()
    xdt = xh * dt[..., None]
    state = state * da[..., None, None] + \
        b_in.float()[:, None, :, None] * xdt[:, :, None, :]      # bn,bhp->bhnp
    y = (c_in.float()[:, None, None, :] @ state)[:, :, 0]        # bn,bhnp->bhp
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, dv).to(x.dtype)
    y = L.rms_norm(y * F.silu(z[:, None]), p["norm"])
    return y @ p["wout"].to(x.dtype), state
