"""Surrogate scientific fields, made on the device from a seed.

SDRBench's fields are not shipped with the repository, so each
configuration's fields are made by the recipe of the paper-calibrated
surrogates: integrated Gaussian noise (a cumulative sum along every
axis, in float64), scaled to span [-1, 1] exactly, plus white noise of
the configuration's law and amplitude, which sets how well Lorenzo
predicts the field and so its compression ratio.  The amplitude of each
configuration was found once on the card, at the configuration's own
size (``calibrate.py``).

The base spans [-1, 1] exactly, not ``max|base| = 1`` as the CPU-era
surrogates had it: a relative error bound follows the range, and a range
that swings with the seed would let the seed change the work (the ratio
moved 3% from seed to seed).  Every field has a seed of its own, mixed
from the run's seed and the field's index, so one seed gives the same
fields on every run.
"""

from __future__ import annotations

import numpy as np
import torch


def field_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for field ``index`` of run ``seed``."""
    state = np.random.SeedSequence([seed & (2**64 - 1), index])
    lo, hi = state.generate_state(2, np.uint32)
    return (int(hi) << 31 | int(lo)) & (2**63 - 1)


NOISES = ("gaussian", "uniform")


def make(shape, noise_amp: float, seed: int, index: int, device,
         noise: str = "gaussian") -> torch.Tensor:
    """Field ``index`` of run ``seed``: float32 of ``shape`` on ``device``.

    ``noise`` is the white noise's law: ``"gaussian"`` (N(0, 1)) or
    ``"uniform"`` (U(-1, 1)), times ``noise_amp``."""
    if noise not in NOISES:
        raise ValueError(f"noise must be one of {NOISES}, got {noise!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(field_seed(seed, index))
    base = torch.randn(tuple(shape), generator=gen, dtype=torch.float64,
                       device=device)
    for axis in range(base.ndim):
        base = torch.cumsum(base, dim=axis)
    lo, hi = base.min(), base.max()
    base = (base - lo) * (2.0 / (hi - lo + 1e-300)) - 1.0
    x = base.to(torch.float32)
    del base
    white = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if noise == "gaussian":
        white.normal_(generator=gen)
    else:
        white.uniform_(-1.0, 1.0, generator=gen)
    return x.add_(white, alpha=float(np.float32(noise_amp)))
