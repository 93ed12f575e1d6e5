"""The benchmark's own yardsticks: compressed size, byte bounds, peaks.

``compressed_bytes`` is the paper's accounting of a compressed field, as
cuSZ stores it: the payload's bytes, one byte of gap a 128-bit
subsequence, 8 bytes a valid outlier (a 4-byte position and a 4-byte
value) and the codebook (2 bytes an entry of the ``2**max_len`` table).
The least bytes a read or a write moves are the compressed field once and
the float32 field once, whatever kernels or intermediate arrays carry
them.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def compressed_bytes(total_bits: int, n_subseq: int, n_outliers: int,
                     max_len: int) -> int:
    """Stored bytes of one compressed field."""
    return -(-int(total_bits) // 8) + int(n_subseq) + 8 * int(n_outliers) \
        + 2 * (1 << int(max_len))


def footprint(c) -> dict:
    """What the accounting needs of a ``Compressed``: its sizes, read once
    (the outlier count is one reduction on the device)."""
    return {"total_bits": int(c.stream.total_bits),
            "n_subseq": int(c.stream.gaps.shape[0]),
            "n_outliers": int((c.outlier_pos >= 0).sum()),
            "max_len": int(c.codebook.max_len),
            "original_bytes": int(c.n_symbols) * c.dtype.itemsize}


def stored(fp: dict) -> int:
    return compressed_bytes(fp["total_bits"], fp["n_subseq"],
                            fp["n_outliers"], fp["max_len"])


def ratio(fps) -> float:
    """Original over stored bytes, over all the fields given."""
    return sum(fp["original_bytes"] for fp in fps) / sum(stored(fp)
                                                         for fp in fps)


def least_bytes(fp: dict) -> int:
    """Bytes a read or a write of the field must move: the compressed
    field once and the float32 field once."""
    return stored(fp) + fp["original_bytes"]


def peaks(kind: str) -> "dict | None":
    """The published peaks of the card named ``kind``, or None."""
    table = json.loads(PEAKS.read_text())
    for name, row in table["cards"].items():
        if name in kind:
            return row
    return None


def device_kind(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
