"""The one traffic generator: a mix file of parameters -> the operations.

Every mix is a closed loop of one client: it sends its next operation
when the last one has returned, and passes over the fields held round
robin, in an order drawn from the seed.  A mix (``mixes/<name>.json``)
names the operation (``"read"``: one ``Codec.decompress`` of a held
field, synchronised; ``"write"``: one ``Codec.compress`` of a held
original) and the plan-cache bound of the codec (``plan_cache_size``,
the codec's default where absent).

The seed changes the order, never the work: every seed's run passes over
the same fields in another order.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MIXES = Path(__file__).resolve().parent / "mixes"
OPS = ("read", "write")


def load(name: str) -> dict:
    """The mix named ``name``: the one file ``mixes/<name>.*``."""
    found = sorted(MIXES.glob(f"{name}.*"))
    if len(found) != 1:
        raise FileNotFoundError(f"mix {name!r}: expected one file "
                                f"mixes/{name}.*, found {len(found)}")
    mix = json.loads(found[0].read_text())
    if mix.get("op") not in OPS:
        raise ValueError(f"mix {name!r}: op must be one of {OPS}")
    return mix


def order(n_fields: int, seed: int) -> list:
    """One round of the loop: every field once, in an order from the seed;
    the loop repeats the round."""
    rng = np.random.default_rng([seed & (2**64 - 1), 1])
    return [int(i) for i in rng.permutation(n_fields)]
