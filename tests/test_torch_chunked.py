"""cuSZ's chunked baseline coder in the port against the JAX package's.

``encode_chunked`` of the port must return the reference's dict, every
field bit for bit (``chunk_bits`` compared by value: the reference's is
int32 without x64, the port's int64).  ``decode_chunked_plain`` (the torch
ops version of the ``decode_chunked`` CUDA kernel) must equal the JAX
``decode_chunked`` bit for bit, zeros included.  The tolerance is zero
everywhere.  Everything runs on the CPU; the kernel itself is held against
its plain version in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.huffman import codebook as jcb
from repro.core.huffman import decode as jhd
from repro.core.huffman import encode as jhe

from repro_torch.core.huffman import codebook as cb
from repro_torch.core.huffman import decode as hd
from repro_torch.core.huffman import encode as he
from repro_torch.kernels import huffman_chunked as HC
from repro_torch.kernels import launches


def _book(max_len: int, vocab: int = 300, seed: int = 0):
    """A codebook built by both packages from one histogram: a geometric
    head (long codes at ``max_len``) over a uniform floor."""
    rng = np.random.default_rng(seed)
    freq = (np.maximum(1, 1e6 * 0.7 ** np.arange(vocab)).astype(np.int64)
            + rng.integers(0, 3, vocab))
    book = cb.build_codebook(freq, max_len=max_len)
    jbook = jcb.build_codebook(freq, max_len=max_len)
    assert np.array_equal(book.enc_code, jbook.enc_code)
    assert np.array_equal(book.enc_len, jbook.enc_len)
    return book


def _syms(n: int, vocab: int = 300, seed: int = 1):
    """Symbols drawn uniformly, so the long codes occur."""
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.uint16)


def _both(syms, book, chunk):
    got = he.encode_chunked(torch.from_numpy(syms.astype(np.int64)),
                            book.enc_code, book.enc_len, chunk)
    want = jhe.encode_chunked(syms, book.enc_code, book.enc_len, chunk)
    return got, want


@pytest.mark.parametrize("chunk", [1, 128, 512, 16384])
@pytest.mark.parametrize("n", [5000, 16384 * 2 + 77, 100])
def test_encode_chunked_matches_reference(chunk, n):
    """Every returned field equals the reference's, for chunk sizes 1,
    128, 512 and 16,384, an n that the chunks do not divide, and an n
    below one chunk."""
    book = _book(12)
    got, want = _both(_syms(n), book, chunk)
    assert set(got) == set(want)
    assert got["units"].dtype == torch.uint32
    assert np.array_equal(got["units"].numpy(), np.asarray(want["units"]))
    assert got["chunk_bits"].dtype == torch.int64
    assert np.array_equal(got["chunk_bits"].numpy(),
                          np.asarray(want["chunk_bits"]).astype(np.int64))
    assert got["chunk_syms"].dtype == torch.int32
    assert np.array_equal(got["chunk_syms"].numpy(),
                          np.asarray(want["chunk_syms"]))
    for key in ("chunk_symbols", "n_symbols", "stored_bytes"):
        assert got[key] == want[key], key
        assert type(got[key]) is int


def test_encode_chunked_empty_and_bad_chunk():
    book = _book(12)
    got, want = _both(np.zeros(0, np.uint16), book, 64)
    assert got["units"].shape == tuple(np.asarray(want["units"]).shape)
    assert got["stored_bytes"] == want["stored_bytes"] == 0
    with pytest.raises(ValueError, match="chunk_symbols"):
        he.encode_chunked(torch.zeros(4, dtype=torch.int64), book.enc_code,
                          book.enc_len, 0)


@pytest.mark.parametrize("chunk,n", [(128, 1000), (512, 3 * 512),
                                     (2048, 5000)])
@pytest.mark.parametrize("max_len", [12, 20])
def test_decode_chunked_plain_matches_reference(max_len, chunk, n):
    """The plain version equals the JAX decoder bit for bit, zeros
    included, at max_len 12 and 20, on the reference's own rows."""
    book = _book(max_len, vocab=60)
    syms = _syms(n, vocab=60)
    want_ch = jhe.encode_chunked(syms, book.enc_code, book.enc_len, chunk)
    want = np.asarray(jhd.decode_chunked(
        want_ch["units"], want_ch["chunk_bits"], want_ch["chunk_syms"],
        jnp.asarray(book.dec_sym), jnp.asarray(book.dec_len),
        max_len=max_len, chunk_symbols=chunk))
    got = HC.decode_chunked_plain(
        torch.from_numpy(np.array(want_ch["units"])),
        torch.from_numpy(np.array(want_ch["chunk_bits"], np.int64)),
        torch.from_numpy(np.array(want_ch["chunk_syms"])),
        torch.from_numpy(book.dec_sym), torch.from_numpy(book.dec_len),
        max_len, chunk)
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want.reshape(-1)[:n], syms)
    assert not want.reshape(-1)[n:].any()


def test_decode_chunked_past_the_bits_and_corrupt_rows():
    """Rows whose bits end early (chunk_bits cut), a zero-length LUT entry
    (advance one bit) and a row read past its last unit decode as the
    reference does."""
    book = _book(10, vocab=40)
    syms = _syms(3000, vocab=40)
    ch = jhe.encode_chunked(syms, book.enc_code, book.enc_len, 256)
    units = np.asarray(ch["units"]).copy()
    units[3] ^= np.uint32(0xF0F0F0F0)
    bits = np.asarray(ch["chunk_bits"]).astype(np.int64)
    bits[::2] = bits[::2] // 3
    bits[1] = 32 * units.shape[1] + 100      # past the row
    dec_len = book.dec_len.copy()
    dec_len[::7] = 0
    want = np.asarray(jhd.decode_chunked(
        jnp.asarray(units), jnp.asarray(bits.astype(np.int32)),
        ch["chunk_syms"], jnp.asarray(book.dec_sym), jnp.asarray(dec_len),
        max_len=10, chunk_symbols=256))
    got = hd.decode_chunked(torch.from_numpy(units), torch.from_numpy(bits),
                            torch.from_numpy(np.array(ch["chunk_syms"])),
                            book.dec_sym, dec_len, 10, 256)
    assert np.array_equal(got.numpy(), want)


def test_wrapper_takes_cpu_tensors_to_the_plain_version():
    """On CPU tensors the wrapper runs its plain version and counts no
    launch; it checks its inputs first."""
    book = _book(12)
    syms = _syms(2000)
    ch = he.encode_chunked(torch.from_numpy(syms.astype(np.int64)),
                           book.enc_code, book.enc_len, 256)
    args = (ch["units"], ch["chunk_bits"], ch["chunk_syms"],
            torch.from_numpy(book.dec_sym), torch.from_numpy(book.dec_len))
    before = launches.counts()["decode_chunked"]
    got = HC.decode_chunked(*args, 12, 256)
    assert launches.counts()["decode_chunked"] == before
    assert np.array_equal(got.reshape(-1)[:2000].numpy(), syms)
    with pytest.raises(ValueError, match="max_len"):
        HC.decode_chunked(*args, 0, 256)
    with pytest.raises(ValueError, match="2\\*\\*max_len"):
        HC.decode_chunked(*args, 13, 256)
    with pytest.raises(TypeError, match="chunk_bits"):
        HC.decode_chunked(args[0], args[1].to(torch.int32), *args[2:], 12,
                          256)
    with pytest.raises(ValueError, match="2-D"):
        HC.decode_chunked(args[0].reshape(-1), *args[1:], 12, 256)


@pytest.mark.parametrize("n_chunks,max_len,want", [
    # hacc1d / isabel3d at 16,384 a chunk: one warp a block, one wave
    (1024, 12, 32), (1526, 12, 32),
    # 2,048 a chunk: 12,208 threads still fit one wave of warps
    (12208, 12, 32),
    # the 196 KB LUT of max_len 16 leaves one block an SM: wider blocks
    (1024, 16, 32), (12208, 16, 128), (40000, 16, 256),
    # device-memory LUT, no shared memory: warps again
    (12208, 20, 32), (1, 24, 32)])
def test_geometry_spreads_the_threads(n_chunks, max_len, want):
    """The narrowest block whose grid the card (132 SMs) holds at once; the
    widest when none does; always a thread for every chunk."""
    blocks, threads, smem = HC.decode_chunked_geometry(
        n_chunks, 1 << max_len, 132)
    assert threads == want
    assert blocks * threads >= n_chunks > (blocks - 1) * threads
    assert smem == (HC.decode_chunked_smem(1 << max_len) if max_len <= 16
                    else 0)


def test_lut_placement_by_size():
    """The LUT sits in shared memory up to max_len 16 and in device
    memory from 17, as for the other decode kernels."""
    assert HC.decode_chunked_lut_in_smem(1 << 16)
    assert not HC.decode_chunked_lut_in_smem(1 << 17)
    assert HC.decode_chunked_smem(1 << 12) == 2 * 4096 + 4096


def test_expected_bits_per_symbol_matches_reference():
    book = _book(12)
    freq = np.random.default_rng(3).integers(0, 50, 300)
    assert cb.expected_bits_per_symbol(freq, book.enc_len) == \
        jcb.expected_bits_per_symbol(freq, book.enc_len)
    assert cb.expected_bits_per_symbol(np.zeros(4), np.ones(4)) == 0.0


@settings(max_examples=8, deadline=None)
@given(st.integers(100, 3000), st.sampled_from([64, 512, 1000]),
       st.integers(0, 2**31))
def test_roundtrip_any_chunk(n, chunk, seed):
    """Any n and chunk size: the port's encode then its decode gives the
    symbols back, and the rows equal the reference's."""
    r = np.random.default_rng(seed)
    syms = r.integers(0, 300, size=n).astype(np.uint16)
    freq = np.bincount(syms, minlength=300)
    book = cb.build_codebook(freq, max_len=12)
    ch = he.encode_chunked(torch.from_numpy(syms.astype(np.int64)),
                           book.enc_code, book.enc_len, chunk)
    out = hd.decode_chunked(ch["units"], ch["chunk_bits"], ch["chunk_syms"],
                            book.dec_sym, book.dec_len, 12, chunk)
    assert np.array_equal(out.reshape(-1)[:n].numpy(), syms)
    want = jhe.encode_chunked(syms, book.enc_code, book.enc_len, chunk)
    assert np.array_equal(ch["units"].numpy(), np.asarray(want["units"]))
