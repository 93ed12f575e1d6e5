"""Synthetic scientific fields.

Port of ``smooth_field`` from ``src/repro/data/pipeline.py`` (numpy, so the
same seed gives the same field as the reference).
"""

from __future__ import annotations

import numpy as np


def smooth_field(shape, seed: int = 0, dtype=np.float32):
    """Synthetic 'scientific' field: integrated noise -> Lorenzo-predictable."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float64)
    for ax in range(len(shape)):
        x = np.cumsum(x, axis=ax)
    x /= np.abs(x).max() + 1e-9
    return x.astype(dtype)
