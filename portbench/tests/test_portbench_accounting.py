"""The ratio and roofline byte counts against hand counts."""

import pytest
import torch

from portbench import accounting


def test_compressed_bytes_by_hand():
    # 100 bits -> 13 bytes, 32 gap bytes, 3 outliers x 8, 2**4 x 2 codebook
    assert accounting.compressed_bytes(100, 32, 3, 4) == 13 + 32 + 24 + 32


def test_ratio_and_least_bytes_of_a_tiny_field():
    from repro_torch.core.codec import Codec, CodecConfig

    x = torch.linspace(-1, 1, 4096, dtype=torch.float32)
    x[100] = 3.0                       # |d| of 15,000 bins: an outlier
    codec = Codec(CodecConfig(device="cpu", encode_backend="cuda",
                              mode="abs", eb=1e-4))
    c = codec.compress(x)
    fp = accounting.footprint(c)
    n_out = int((c.outlier_pos >= 0).sum())
    assert n_out >= 1 and fp["n_outliers"] == n_out
    hand = (-(-int(c.stream.total_bits) // 8) + c.stream.gaps.numel()
            + 8 * n_out + 2 * 2 ** c.codebook.max_len)
    assert accounting.stored(fp) == hand
    # The program's own copy of the paper's accounting agrees today.
    assert hand == c.compressed_bytes
    assert accounting.ratio([fp, fp]) == pytest.approx(4 * 4096 / hand)
    assert accounting.least_bytes(fp) == hand + 4 * 4096


def test_peaks_table():
    assert accounting.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] \
        == 3.35e12
    assert accounting.peaks("cpu") is None
