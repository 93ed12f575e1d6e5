"""The plain reference agrees with itself and catches what it must."""

import numpy as np
import pytest
import torch

from portbench.reference import huffman, lattice


def _stream(seed=0, n=5000, k=40):
    rng = np.random.default_rng(seed)
    sym = torch.from_numpy(np.minimum(rng.geometric(0.3, n) - 1, k - 1))
    freq = np.bincount(sym.numpy(), minlength=k)
    code, length = huffman.canonical_code(freq)
    units, gaps, bits = huffman.encode(sym, code, length)
    return sym, code, length, units, gaps, bits


def test_round_trip():
    sym, code, length, units, gaps, bits = _stream()
    out, faults = huffman.decode(units, gaps, bits, sym.numel(), code,
                                 length, int(length.max()))
    assert faults == 0 and torch.equal(out, sym.to(torch.int64))


@pytest.mark.parametrize("lanes", [1, 7, 1 << 22])
def test_round_trip_in_blocks(lanes):
    sym, code, length, units, gaps, bits = _stream(seed=3)
    out, faults = huffman.decode(units, gaps, bits, sym.numel(), code,
                                 length, 16, lanes=lanes)
    assert faults == 0 and torch.equal(out, sym.to(torch.int64))


def test_catches_a_corrupted_code():
    sym, code, length, units, gaps, bits = _stream(seed=1)
    bad = units.clone()
    bad[len(bad) // 3] ^= 1 << 17
    out, faults = huffman.decode(bad, gaps, bits, sym.numel(), code, length,
                                 int(length.max()))
    assert faults > 0 or not torch.equal(out, sym.to(torch.int64))


def test_catches_a_wrong_gap_and_count():
    sym, code, length, units, gaps, bits = _stream(seed=2)
    g = gaps.clone()
    g[3] = (int(g[3]) + 1) % 128
    assert huffman.decode(units, g, bits, sym.numel(), code, length,
                          int(length.max()))[1] > 0
    assert huffman.decode(units, gaps, bits, sym.numel() + 1, code, length,
                          int(length.max()))[1] > 0


def test_rejects_a_code_that_is_not_prefix_free():
    code = np.array([0, 1, 1], np.uint32)
    length = np.array([1, 1, 2], np.uint8)
    assert huffman.lookup_table(code, length, 4)[2] > 0


def test_reads_the_ports_stream():
    from repro_torch.core.codec import Codec, CodecConfig

    from portbench import fields, judge

    x = fields.make((3, 40, 50), 0.004, 5, 0, "cpu")
    codec = Codec(CodecConfig(device="cpu", encode_backend="cuda"))
    c = codec.compress(x)
    xr, faults = judge.decoded_field(c, x.shape)
    assert faults == 0
    eb = lattice.abs_eb(x, 1e-3)
    assert lattice.mismatches(xr, lattice.lattice(x, eb)) == 0
    assert lattice.mismatches(codec.decompress(c), xr) == 0
    assert lattice.max_error(x, xr) <= lattice.guarantee(x, eb)


def test_catches_a_bfloat16_reconstruction():
    from portbench import fields

    x = fields.make((20000,), 0.05, 9, 0, "cpu")
    eb = lattice.abs_eb(x, 1e-3)
    ref = lattice.lattice(x, eb)
    low = lattice.lattice(x, eb, compute=torch.bfloat16)
    assert lattice.mismatches(low, ref) > 0
    assert lattice.max_error(x, low) > lattice.guarantee(x, eb)
    assert lattice.max_error(x, ref) <= lattice.guarantee(x, eb)


def test_negative_zero_is_the_lattice_zero():
    x = torch.tensor([-1e-9, 0.0, 1.0, -1.0], dtype=torch.float32)
    out = lattice.lattice(x, 1e-3)
    assert lattice.mismatches(out[:2], torch.zeros(2)) == 0
