"""The CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device: it is marked ``cuda`` and skips when
``torch.cuda.is_available()`` is false (decided in the fixture, never at
import).  This file imports no JAX, so it also runs on a machine that has
PyTorch for CUDA and nothing of the JAX stack:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import codebook, encode
from repro_torch.core.huffman import decode as hd
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor, lorenzo
from repro_torch.data.pipeline import smooth_field
from repro_torch.kernels import histogram as H
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels import huffman_encode as E
from repro_torch.kernels import huffman_selfsync as S
from repro_torch.kernels import launches
from repro_torch.kernels import lorenzo as L
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _signed(t):
    return t.view({torch.uint16: torch.int16,
                   torch.uint32: torch.int32}.get(t.dtype, t.dtype))


def _payload(cuda, shape, seed, noise, radius=512, max_len=12):
    rng = np.random.default_rng(seed)
    x = smooth_field(shape, seed=seed) + np.float32(noise) * \
        rng.standard_normal(shape).astype(np.float32)
    codec = Codec(CodecConfig(radius=radius, max_len=max_len,
                              device=str(cuda)))
    return codec, torch.from_numpy(x).to(cuda), codec.compress(
        torch.from_numpy(x).to(cuda))


@pytest.mark.parametrize("shape,noise,tile", [
    ((20000,), 1e-4, 4096), ((30, 40, 50), 2e-3, 4096),
    ((300, 400), 3e-2, 1024), ((7, 9), 0.0, 512),
    # > 48 KB of shared memory and > 1024 lanes a block
    ((200000,), 1e-3, 20000)])
def test_kernels_match_plain(cuda, shape, noise, tile):
    codec, x, c = _payload(cuda, shape, 3, noise)
    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, cuda)
    args = (c.stream.units, plan.start_bits, plan.end_bits,
            c.stream.total_bits, luts.dec_sym, luts.dec_len, luts.max_len)
    before = K.count_subseq.launches
    kc, kl = K.count_subseq(*args)
    assert K.count_subseq.launches == before + 1
    pc, pl = K.count_subseq_plain(*args)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    s0 = ops._tile_inputs(plan.offsets, c.stream.n_subseq, c.n_symbols,
                          tile)
    targs = (c.stream.units, plan.start_bits, plan.end_bits, plan.offsets,
             s0, c.stream.total_bits, luts.dec_sym, luts.dec_len,
             luts.max_len, tile, hp.ss_max_for_tile(tile, luts.max_len),
             c.n_symbols)
    kt = K.decode_tiles(*targs)
    pt = K.decode_tiles_plain(*targs)
    assert torch.equal(_signed(kt), _signed(pt))
    want = lorenzo.quantize_host(x, c.eb, c.radius)[0].reshape(-1)
    assert torch.equal(_signed(kt), _signed(want))


def test_merged_lut_base(cuda):
    codec, x, c = _payload(cuda, (5000,), 5, 1e-3)
    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, cuda)
    size = 1 << luts.max_len
    ds = torch.cat([torch.zeros(size, dtype=torch.uint16, device=cuda),
                    luts.dec_sym])
    dl = torch.cat([torch.ones(size, dtype=torch.uint8, device=cuda),
                    luts.dec_len])
    base = torch.full((c.stream.n_subseq,), size, dtype=torch.int32,
                      device=cuda)
    args = (c.stream.units, ds, dl, plan.start_bits, plan.end_bits,
            plan.offsets, c.stream.total_bits, luts.max_len, c.n_symbols,
            4096, hp.ss_max_for_tile(4096, luts.max_len))
    got = ops.decode_write_tiles(*args, lut_base=base)
    ref = codec.decode(c.stream, c.codebook, c.n_symbols)
    assert torch.equal(_signed(got), _signed(ref))


def test_default_codec_round_trip(cuda):
    x = torch.from_numpy(smooth_field((64, 64, 64), seed=2)).to(cuda)
    codec = Codec()
    launches.reset()
    c = codec.compress(x)
    y = codec.decompress(c)
    assert y.device.type == "cuda" and y.dtype == x.dtype
    assert (y.double() - x.double()).abs().max().item() <= c.eb_effective
    assert K.count_subseq.launches == 1 and K.decode_tiles.launches == 1
    ref = Codec(CodecConfig(backend="ref")).decompress(c.to("cpu"))
    assert torch.equal(y.cpu(), ref)
    codec.reset_stats()
    codec.decompress(c)                   # same payload: plan cache hit
    assert codec.stats["plan_hits"] == 1 and codec.stats["plan_builds"] == 0


def test_shared_memory_bound(cuda):
    """A LUT whose lengths alone (count_subseq stages nothing else) cannot
    sit in shared memory (2**18 entries) launches the variant that reads
    them from device memory, and equals the plain version."""
    assert not K.count_subseq_lut_in_smem(1 << 18)
    assert K.count_subseq_geometry(32, 1 << 18, K.sm_count(0))[2] == 0
    rng = np.random.default_rng(18)
    units = torch.from_numpy(rng.integers(0, 2**32, 4096, dtype=np.uint64)
                             .astype(np.uint32)).to(cuda)
    start = torch.arange(1000, dtype=torch.int32, device=cuda) * 128 + \
        torch.from_numpy(rng.integers(0, 40, 1000).astype(np.int32)).to(cuda)
    ds = torch.from_numpy(rng.integers(0, 1000, 1 << 18).astype(np.uint16)
                          ).to(cuda)
    dl = torch.from_numpy(rng.integers(0, 19, 1 << 18).astype(np.uint8)
                          ).to(cuda)
    args = (units, start, start + 128, 4096 * 32, ds, dl, 18)
    before = K.count_subseq.launches
    kc, kl = K.count_subseq(*args)
    assert K.count_subseq.launches == before + 1
    pc, pl = K.count_subseq_plain(*args)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    assert int(kc.sum()) > 1000


@pytest.fixture
def no_plain_versions(monkeypatch):
    """Every decode kernel's plain version, and reconstruct1d's, raises if
    called: a wrapper handed a CUDA tensor must launch its kernel (the
    shared-memory variant or the device-memory one), never fall back to
    torch ops."""
    from repro_torch.kernels import fused_decode as fd

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran for a CUDA tensor")

    for mod, name in ((K, "count_subseq_plain"), (K, "decode_tiles_plain"),
                      (K, "decode_padded_plain"),
                      (S, "selfsync_intra_plain"),
                      (fd, "decode_tiles_fused_plain"),
                      (fd, "decode_tiles_fused_nd_plain"),
                      (fd, "dequant_reconstruct_plain"),
                      (fd, "dequant_reconstruct_nd_plain"),
                      (L, "reconstruct1d_plain")):
        monkeypatch.setattr(mod, name, refuse)


LONG_CODE_KERNELS = {
    ("tile", "gap"): ("count_subseq", "decode_tiles"),
    ("padded", "gap"): ("count_subseq", "decode_padded"),
    ("tuned", "gap"): ("count_subseq", "decode_tiles"),
    ("tile", "selfsync"): ("selfsync_intra", "decode_tiles"),
    ("padded", "selfsync"): ("selfsync_intra", "decode_padded"),
    ("tuned", "selfsync"): ("selfsync_intra", "decode_tiles"),
}


@pytest.fixture(scope="module")
def long_code_payload():
    """A 3-D field compressed on the CPU by the "ref" codec at max_len 20
    (a 2**20-entry LUT, 3 MB: past shared memory for every decode kernel),
    and its "ref" decompress."""
    shape = (24, 50, 60)
    rng = np.random.default_rng(20)
    x = smooth_field(shape, seed=20) + np.float32(3e-2) * \
        rng.standard_normal(shape).astype(np.float32)
    ref = Codec(CodecConfig(max_len=20, backend="ref"))
    c = ref.compress(torch.from_numpy(x))
    return c, ref.decompress(c)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("strategy,method", list(LONG_CODE_KERNELS))
def test_long_codes_decode_on_card(cuda, no_plain_versions,
                                   long_code_payload, strategy, method,
                                   fused):
    """A max_len 20 stream decodes through the default "cuda" Codec bit for
    bit against backend="ref", on every strategy, both methods, fused on
    and off, through the kernels' device-memory LUT variants; the fused
    tile path falls back to two-pass (its LUT does not fit beside a tile),
    counted, and the padded fused epilogue (no LUT) runs."""
    c, want = long_code_payload
    assert c.codebook.max_len == 20
    codec = Codec(CodecConfig(max_len=20, strategy=strategy, method=method,
                              fused=fused))
    cc = c.to(codec.device)
    codec.reset_stats()
    launches.reset()
    y = codec.decompress(cc)
    counts = launches.counts()
    assert y.device.type == "cuda" and torch.equal(y.cpu(), want)
    for name in LONG_CODE_KERNELS[(strategy, method)]:
        assert counts[name] >= 1, (name, counts)
    if fused and strategy == "padded":
        assert counts["dequant_reconstruct_nd"] == 1
        assert codec.stats["fused_dispatches"] == 1
    elif fused:
        assert codec.stats["fused_fallbacks"] >= 1
        assert counts["decode_tiles_fused_nd"] == 0



@pytest.fixture(scope="module")
def wide_tile_payload():
    """A 3-D field of 600,000 values compressed on the CPU by the "ref"
    codec, half of its planes zero (sequences of compression ratio 16, so
    class 16 at t_high 113), and its "ref" decompress."""
    shape = (60, 100, 100)
    rng = np.random.default_rng(21)
    x = smooth_field(shape, seed=21) + np.float32(1e-2) * \
        rng.standard_normal(shape).astype(np.float32)
    x[:30] = 0
    ref = Codec(CodecConfig(backend="ref"))
    c = ref.compress(torch.from_numpy(x))
    return c, ref.decompress(c)


@pytest.mark.parametrize("strategy,method,tile_syms,t_high", [
    ("tile", "gap", 116224, hp.T_HIGH_DEFAULT),
    ("tile", "selfsync", 116224, hp.T_HIGH_DEFAULT),
    ("tuned", "gap", 4096, 113),
    ("tuned", "selfsync", 4096, 113)])
def test_widest_staging_tiles_decode_on_card(cuda, no_plain_versions,
                                            wide_tile_payload, strategy,
                                            method, tile_syms, t_high):
    """The widest tiles a "cuda" config accepts decode bit for bit against
    backend="ref" on the tile, tuned and opt self-sync paths: tile_syms
    116,224 (the staging tile alone fills shared memory; decode_tiles
    reads the LUT from device memory) and t_high 113 (class tiles up to
    115,712 codes; this field's sequences reach class 16, past the
    default t_high's overflow class)."""
    c, want = wide_tile_payload
    codec = Codec(CodecConfig(strategy=strategy, method=method,
                              tile_syms=tile_syms, t_high=t_high))
    cc = c.to(codec.device)
    launches.reset()
    y = codec.decompress(cc)
    counts = launches.counts()
    assert y.device.type == "cuda" and torch.equal(y.cpu(), want)
    assert counts["decode_tiles"] >= 1
    assert counts["selfsync_intra" if method == "selfsync"
                  else "count_subseq"] >= 1
    if strategy == "tile":
        assert -(-c.n_symbols // tile_syms) > 1
        assert not K.decode_tiles_lut_in_smem(tile_syms,
                                              1 << c.codebook.max_len)
    else:
        assert int(codec.plan_for(cc).classes.classes.max()) > \
            hp.T_HIGH_DEFAULT


def test_cpu_inputs_never_launch(cuda):
    units = torch.zeros(128, dtype=torch.uint32)
    s = torch.zeros(32, dtype=torch.int32)
    before = K.count_subseq.launches
    K.count_subseq(units, s, s + 128, 0, torch.zeros(16, dtype=torch.uint16),
                   torch.ones(16, dtype=torch.uint8), 4)
    assert K.count_subseq.launches == before


def _stream(cuda, freq, n, max_len, seed):
    rng = np.random.default_rng(seed)
    book = codebook.build_codebook(freq, max_len=max_len)
    syms = rng.choice(len(freq), size=n, p=freq / freq.sum())
    stream = encode.encode(torch.from_numpy(syms).to(cuda),
                           torch.from_numpy(book.enc_code).to(cuda),
                           torch.from_numpy(book.enc_len).to(cuda))
    return book, syms, stream


@pytest.mark.parametrize("name,max_len", [("one-bit", 12), ("flat", 16),
                                          ("short", 4)])
def test_codebooks_at_the_edges(cuda, name, max_len):
    """1-bit codes (128 codewords a subsequence, the slot-127 clamp), a
    2**16-entry LUT (196 KB of shared memory) and a 4-bit cap."""
    freq = {"one-bit": np.array([10**6, 3, 2, 1]),
            "flat": np.full(1024, 5),
            "short": np.arange(1, 17)}[name]
    book, syms, stream = _stream(cuda, freq, 30000, max_len, 1)
    ds = torch.from_numpy(book.dec_sym).to(cuda)
    dl = torch.from_numpy(book.dec_len).to(cuda)
    bnd = torch.arange(stream.n_subseq, dtype=torch.int32, device=cuda) * 128
    start = bnd + stream.gaps.to(torch.int32)
    args = (stream.units, start, bnd + 128, stream.total_bits, ds, dl,
            max_len)
    kc, kl = K.count_subseq(*args)
    pc, pl = K.count_subseq_plain(*args)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    assert int(kc.sum()) == syms.shape[0]
    got = ops.decode_write_tiles(stream.units, ds, dl, start, bnd + 128,
                                 hd.output_offsets(kc), stream.total_bits,
                                 max_len, syms.shape[0], 4096,
                                 hp.ss_max_for_tile(4096, max_len))
    assert np.array_equal(got.cpu().to(torch.int64).numpy(), syms)


def test_corrupt_windows_match_plain(cuda):
    """Negative, inverted, overlong and out-of-stream windows follow the
    reference's window rules in the kernel as in the plain version."""
    freq = np.bincount(np.random.default_rng(0).zipf(1.3, 20000) % 300,
                       minlength=300)
    book, _, stream = _stream(cuda, freq, 5000, 12, 2)
    rng = np.random.default_rng(3)
    nbits = stream.units.shape[0] * 32
    start = rng.integers(-300, nbits + 300, size=4000)
    end = start + rng.integers(-60, 500, size=4000)
    args = (stream.units, torch.from_numpy(start.astype(np.int32)).to(cuda),
            torch.from_numpy(end.astype(np.int32)).to(cuda),
            stream.total_bits, torch.from_numpy(book.dec_sym).to(cuda),
            torch.from_numpy(book.dec_len).to(cuda), 12)
    kc, kl = K.count_subseq(*args)
    pc, pl = K.count_subseq_plain(*args)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)


def _count_args(cuda, shape, seed, noise):
    codec, x, c = _payload(cuda, shape, seed, noise)
    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, cuda)
    return codec, c, plan, luts


@pytest.mark.parametrize("size", ["one", "below-a-block", "past-a-round"])
def test_count_subseq_grid_edges(cuda, size):
    """One window, fewer windows than a block, and more windows than the
    resident blocks' threads hold, not a multiple of them (a grid-stride
    round and a partial one): the kernel equals its plain version."""
    codec, c, plan, luts = _count_args(cuda, (200000,), 11, 1e-3)
    geom_n = K.count_subseq_geometry(1 << 30, luts.dec_sym.numel(),
                                     K.sm_count(cuda.index or 0))
    resident = geom_n[0] * geom_n[1]
    n = {"one": 1, "below-a-block": 100,
         "past-a-round": resident + 1001}[size]
    idx = torch.arange(n, device=cuda) % c.stream.n_subseq
    args = (c.stream.units, plan.start_bits[idx].contiguous(),
            plan.end_bits[idx].contiguous(), c.stream.total_bits,
            luts.dec_sym, luts.dec_len, luts.max_len)
    blocks, threads, _ = K.count_subseq_geometry(
        n, luts.dec_sym.numel(), K.sm_count(cuda.index or 0))
    assert blocks <= -(-n // threads)
    if size == "past-a-round":
        assert blocks * threads < n and n % (blocks * threads)
    kc, kl = K.count_subseq(*args)
    pc, pl = K.count_subseq_plain(*args)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)


def _tile_args(c, plan, luts, tile, offsets=None, start=None, end=None,
               n_out=None, ss_max=None):
    start = plan.start_bits if start is None else start
    end = plan.end_bits if end is None else end
    offsets = plan.offsets if offsets is None else offsets
    n_out = c.n_symbols if n_out is None else n_out
    s0 = ops._tile_inputs(offsets, start.shape[0], n_out, tile)
    return (c.stream.units, start, end, offsets, s0, c.stream.total_bits,
            luts.dec_sym, luts.dec_len, luts.max_len, tile,
            hp.ss_max_for_tile(tile, luts.max_len) if ss_max is None
            else ss_max, n_out)


@pytest.mark.parametrize("case", ["tiles-many-times-resident",
                                  "fewer-tiles-than-sms", "class-tile-8192"])
def test_decode_tiles_grid_edges(cuda, case):
    """Tiles that outnumber the resident blocks many times over (each block
    loops over tiles), fewer tiles than SMs, and a tuned class tile of
    8,192 codes: the kernel equals its plain version and the codes."""
    shape, tile = {"tiles-many-times-resident": ((64, 128, 256), 64),
                   "fewer-tiles-than-sms": ((30, 40, 50), 4096),
                   "class-tile-8192": ((64, 128, 128), 8192)}[case]
    codec, c, plan, luts = _count_args(cuda, shape, 12, 2e-3)
    args = _tile_args(c, plan, luts, tile)
    n_tiles = args[4].shape[0]
    blocks, threads, smem = K.decode_tiles_geometry(
        n_tiles, c.stream.n_subseq, tile, args[10], luts.dec_sym.numel(),
        K.sm_count(cuda.index or 0))
    if case == "tiles-many-times-resident":
        assert n_tiles >= 10 * blocks
    elif case == "fewer-tiles-than-sms":
        assert n_tiles == blocks < K.sm_count(cuda.index or 0)
    got = K.decode_tiles(*args)
    assert torch.equal(_signed(got), _signed(K.decode_tiles_plain(*args)))
    want = codec.decode(c.stream, c.codebook, c.n_symbols)
    assert torch.equal(_signed(got), _signed(want))


def test_decode_tiles_span_past_ss_max(cuda):
    """A run of 600 empty windows (count 0) makes one tile's span of
    subsequences longer than ss_max; the kernel drops the lanes past the
    budget exactly as the plain version does."""
    codec, c, plan, luts = _count_args(cuda, (100000,), 8, 1e-3)
    start = plan.start_bits.clone()
    end = plan.end_bits.clone()
    end[500:1100] = start[500:1100]
    kc, _ = K.count_subseq(c.stream.units, start, end, c.stream.total_bits,
                           luts.dec_sym, luts.dec_len, luts.max_len)
    args = _tile_args(c, plan, luts, 4096, offsets=hd.output_offsets(kc),
                      start=start, end=end, n_out=int(kc.sum()))
    s0 = args[4]
    span = s0[1:] - s0[:-1] + 1
    assert int(span.max()) > args[10] and int(span.argmax()) + 1 < s0.numel()
    got = K.decode_tiles(*args)
    assert torch.equal(_signed(got), _signed(K.decode_tiles_plain(*args)))


@pytest.mark.parametrize("lens", ["mixed", "mostly-zero"])
def test_corrupt_lengths_match_plain(cuda, lens):
    """A LUT with zero lengths and lengths of 31 to 255 (past the 64-bit
    buffer) through both kernels: counts, landings and codes equal the
    plain versions'.  Mostly zero lengths (one bit a codeword) over
    160-bit windows put more than 128 codewords in a window, so the slot
    clamp is reached."""
    codec, c, plan, luts = _count_args(cuda, (40, 50, 60), 4, 2e-3)
    rng = np.random.default_rng(5)
    dl = luts.dec_len.cpu().numpy().copy()
    if lens == "mostly-zero":
        dl[:] = 0
    else:
        idx = rng.integers(0, dl.size, size=dl.size // 6)
        dl[idx[:idx.size // 2]] = 0
        dl[idx[idx.size // 2:]] = rng.integers(65, 256, size=idx.size
                                               - idx.size // 2)
    dl[:7] = [0, 31, 32, 33, 63, 64, 200]
    dl = torch.from_numpy(dl).to(cuda)
    end = (plan.start_bits + 160 if lens == "mostly-zero"
           else plan.end_bits)
    cargs = (c.stream.units, plan.start_bits, end, c.stream.total_bits,
             luts.dec_sym, dl, luts.max_len)
    kc, kl = K.count_subseq(*cargs)
    pc, pl = K.count_subseq_plain(*cargs)
    assert torch.equal(kc, pc) and torch.equal(kl, pl)
    assert (int(pc.max()) > 128) == (lens == "mostly-zero")
    bad = dataclasses.replace(luts, dec_len=dl)
    args = _tile_args(c, plan, bad, 1024, offsets=hd.output_offsets(pc),
                      end=end, n_out=int(pc.sum()))
    got = K.decode_tiles(*args)
    assert torch.equal(_signed(got), _signed(K.decode_tiles_plain(*args)))


def test_repeated_launches_identical(cuda):
    """Two launches of each kernel on the same inputs give the same
    bytes."""
    codec, c, plan, luts = _count_args(cuda, (50, 60, 70), 13, 2e-3)
    cargs = (c.stream.units, plan.start_bits, plan.end_bits,
             c.stream.total_bits, luts.dec_sym, luts.dec_len, luts.max_len)
    a, b = K.count_subseq(*cargs), K.count_subseq(*cargs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    args = _tile_args(c, plan, luts, 4096)
    assert torch.equal(_signed(K.decode_tiles(*args)),
                       _signed(K.decode_tiles(*args)))


# ---------------------------------------------------------------------------
# Fused decode kernels: carry-heavy shapes against their plain versions
# ---------------------------------------------------------------------------


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _fused_call(codec, c, tile):
    """The fused kernel, its plain version and their arguments for ``c``."""
    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, c.device)
    return ops.fused_tile_inputs(
        c.stream.units, luts.dec_sym, luts.dec_len, plan.start_bits,
        plan.end_bits, plan.offsets, c.stream.total_bits, luts.max_len,
        c.n_symbols, tile, hp.ss_max_for_tile(tile, luts.max_len),
        c.outlier_pos, c.outlier_val, c.eb, c.radius, shape=c.shape,
        out_dtype=c.dtype)


def _fused_payload(cuda, shape, seed, noise, dtype, radius=512, max_len=12):
    rng = np.random.default_rng(seed)
    x = smooth_field(shape, seed=seed) + np.float32(noise) * \
        rng.standard_normal(shape).astype(np.float32)
    codec = Codec(CodecConfig(radius=radius, max_len=max_len,
                              device=str(cuda)))
    return codec, codec.compress(torch.from_numpy(x).to(cuda).to(dtype))


FUSED_CASES = {
    # 15,625 tiles of 64 codes: a long decoupled look-back
    "1d-64-code-tiles": ((1_000_000,), 64, 1e-3, 512, 12, "decode_tiles_fused"),
    # one row per tile: one row chain of 2,500 units of 8 tiles
    "2d-row-per-tile": ((20000, 64), 64, 1e-3, 512, 12,
                        "decode_tiles_fused_nd"),
    # 200 planes of 4 tiles, 2 planes a unit: more plane groups than units
    # a plane; fused_tile_rows steps w from 10 down to 8
    "3d-200-planes": ((200, 32, 48), 512, 1e-3, 512, 12,
                      "decode_tiles_fused_nd"),
    # 4 planes of 50 tiles: fewer planes than units a plane (the last
    # diagonals of the unit order shrink)
    "3d-4-planes": ((4, 600, 40), 512, 1e-3, 512, 12,
                    "decode_tiles_fused_nd"),
    # most codes are outliers
    "outlier-dense": ((300, 500), 4096, 5e-2, 4, 12,
                      "decode_tiles_fused_nd"),
    # the same for a flat field: rows of 128 codes with more than a warp's
    # 32 outliers, in units of 4,096- and of 64-code tiles
    "1d-outlier-dense": ((1_000_000,), 4096, 5e-2, 4, 12,
                         "decode_tiles_fused"),
    "1d-outlier-dense-64": ((300_001,), 64, 5e-2, 4, 12,
                            "decode_tiles_fused"),
    # one unit: no carry at all
    "2d-one-unit": ((7, 9), 4096, 1e-3, 512, 12, "decode_tiles_fused_nd"),
    # 2,501 units of 8 one-row tiles, the last one partial, more than the
    # ring's 561 slots and the 528 resident blocks
    "2d-partial-group": ((20001, 64), 64, 1e-3, 512, 12,
                         "decode_tiles_fused_nd"),
    # 400 planes of 32 two-row tiles: 2,560 units of 5 planes, more than
    # the ring's 816 slots: slots are reused behind the gate
    "3d-ring-reuse": ((400, 64, 20), 64, 1e-3, 512, 12,
                      "decode_tiles_fused_nd"),
    # 256 planes in groups of 7: the last group holds 4
    "3d-partial-plane-group": ((256, 100, 16), 64, 1e-3, 512, 12,
                               "decode_tiles_fused_nd"),
    # one tile a plane: plane chains only
    "3d-one-tile-a-plane": ((50, 8, 300), 4096, 1e-3, 512, 12,
                            "decode_tiles_fused_nd"),
    # one plane: squeezed to 2-D
    "3d-one-plane": ((1, 300, 40), 512, 1e-3, 512, 12,
                     "decode_tiles_fused_nd"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_kernels_match_plain(cuda, case, dtype):
    shape, tile, noise, radius, max_len, name = FUSED_CASES[case]
    codec, c = _fused_payload(cuda, shape, 11, noise, dtype, radius, max_len)
    kernel, plain, args = _fused_call(codec, c, tile)
    assert kernel.__name__ == name
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    want = plain(*args)
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    if "outlier-dense" in case:
        assert int((c.outlier_pos >= 0).sum()) > c.n_symbols // 4
    # the codec's fused path gives the two-pass bytes
    fused = Codec(codec.config.replace(fused=True, tile_syms=tile))
    fused.reset_stats()
    y = fused.decompress(c)
    assert fused.stats["fused_dispatches"] == 1
    assert fused.stats["fused_fallbacks"] == 0
    two_pass = Codec(codec.config.replace(tile_syms=tile)).decompress(c)
    assert torch.equal(_bits(y), _bits(two_pass))


def test_fused_row_at_the_shared_memory_bound(cuda):
    """The widest row the N-D kernel takes at max_len 12 (a one-row tile
    of 54,960 codes, 5,498 lanes); one column more falls back."""
    import dataclasses

    from repro_torch.core.sz import compressor

    cols = compressor.fused_max_cols(12)
    codec, c = _fused_payload(cuda, (3, cols), 4, 1e-3, torch.float32)
    kernel, plain, args = _fused_call(codec, c, 4096)
    assert kernel.__name__ == "decode_tiles_fused_nd" and args[9] == 1
    assert torch.equal(_bits(kernel(*args)), _bits(plain(*args)))
    assert compressor.fused_unsupported_reason(c, "cuda", "gap",
                                               "tile") is None
    wide = dataclasses.replace(c, shape=(3, cols + 1))
    assert "per-tile row bound" in compressor.fused_unsupported_reason(
        wide, "cuda", "gap", "tile")


@pytest.mark.parametrize("case", ["1d-64-code-tiles", "2d-row-per-tile",
                                  "3d-200-planes", "3d-4-planes",
                                  "2d-partial-group", "3d-ring-reuse"])
def test_fused_repeated_launches_identical(cuda, case):
    """20 launches on one stream, all bit-identical: a race in the carry
    scratch or the ticket order would show as a difference."""
    shape, tile, noise, radius, max_len, _ = FUSED_CASES[case]
    codec, c = _fused_payload(cuda, shape, 12, noise, torch.float32, radius,
                              max_len)
    kernel, plain, args = _fused_call(codec, c, tile)
    outs = [kernel(*args) for _ in range(20)]
    want = plain(*args)
    for out in outs:
        assert torch.equal(_bits(out), _bits(want))


def _fused_1d(cuda, n, tile, seed=5):
    codec, c = _fused_payload(cuda, (n,), seed, 1e-3, torch.float32)
    kernel, plain, args = _fused_call(codec, c, tile)
    assert kernel.__name__ == "decode_tiles_fused"
    return kernel, plain, args


def test_fused_1d_more_units_than_resident_blocks(cuda, no_plain_versions,
                                                  monkeypatch):
    """5,000,000 values in 64-code tiles: more units than 4 x the resident
    blocks, so every block takes many tickets; 5 launches, all the plain
    version's bits (which ran after the kernels, with no plain version
    refused)."""
    from repro_torch.kernels import fused_decode as fd

    kernel, _, args = _fused_1d(cuda, 5_000_000, 64)
    geo = fd.fused_geometry(-(-args[11] // 64), args[1].shape[0], 64,
                            args[10], args[6].numel(), K.sm_count(0))
    assert geo.units > 4 * geo.blocks
    before = kernel.launches
    outs = [kernel(*args) for _ in range(5)]
    assert kernel.launches == before + 5
    monkeypatch.undo()
    want = fd.decode_tiles_fused_plain(*args)
    for out in outs:
        assert torch.equal(_bits(out), _bits(want))


@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_fused_1d_single_tile(cuda, n):
    """One tile: one unit, which publishes its prefix at once."""
    kernel, plain, args = _fused_1d(cuda, n, 4096)
    assert torch.equal(_bits(kernel(*args)), _bits(plain(*args)))


@pytest.mark.parametrize("window", [1, 2, 31, 32])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_fused_1d_window_slides(cuda, monkeypatch, window, k):
    """A look-back window of 1 or 2 units slides on nearly every unit, one
    of 31 or 32 whenever 32 predecessors hold only aggregates; with 1, 3 or
    8 tiles a unit and a last unit that is partial.  Every output is the
    plain version's, for float32, bf16 and f16."""
    from repro_torch.kernels import fused_decode as fd

    def geometry(n_tiles, n_subseq, tile, ss_max, lut, sm):
        return fd.fused_unit_geometry(k, n_tiles, tile, lut, sm)._replace(
            window=window)

    monkeypatch.setattr(fd, "fused_geometry", geometry)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        codec, c = _fused_payload(cuda, (300_001,), 6, 1e-3, dtype)
        kernel, plain, args = _fused_call(codec, c, 256)
        assert torch.equal(_bits(kernel(*args)), _bits(plain(*args)))


@pytest.mark.parametrize("tile", [64, 1001, 4096])
def test_fused_1d_outliers_at_row_and_unit_edges(cuda, tile):
    """Spikes at the first and last codes of every row of 128, of every
    tile and of every warp's chunk, and one run where every code is an
    outlier, become outliers there (radius 4); the 1-D kernel, whose warps
    walk the outlier list beside their rows, equals its plain version bit
    for bit."""
    n = 400_000
    x = smooth_field((n,), seed=23)
    edges = np.concatenate([np.arange(0, n, 128), np.arange(127, n, 128),
                            np.arange(0, n, tile), np.arange(tile - 1, n, tile),
                            np.arange(5000, 5600)])
    edges = np.unique(edges[edges < n])
    rng = np.random.default_rng(23)
    x[edges] += (rng.uniform(50, 150, edges.size) * rng.choice(
        [-1, 1], edges.size)).astype(np.float32)
    codec = Codec(CodecConfig(radius=4, device=str(cuda)))
    c = codec.compress(torch.from_numpy(x).to(cuda))
    opos = c.outlier_pos[c.outlier_pos >= 0].cpu().numpy()
    assert np.isin(edges, opos).mean() > 0.9
    kernel, plain, args = _fused_call(codec, c, tile)
    assert kernel.__name__ == "decode_tiles_fused"
    assert torch.equal(_bits(kernel(*args)), _bits(plain(*args)))


def test_fused_1d_unaligned_tiles(cuda):
    """A tile of 1,001 codes: no unit but the first starts on a 16-byte
    boundary of the output, so the scalar stores run."""
    for dtype in (torch.float32, torch.float16):
        codec, c = _fused_payload(cuda, (250_000,), 8, 1e-3, dtype)
        kernel, plain, args = _fused_call(codec, c, 1001)
        assert torch.equal(_bits(kernel(*args)), _bits(plain(*args)))


def test_fused_1d_entry_refuses_bad_geometry(cuda, monkeypatch):
    """The C entry refuses (-1) a unit of 9 tiles, a window of 0 or 33 and
    too little shared memory, before it launches anything."""
    from repro_torch.kernels import fused_decode as fd

    kernel, _, args = _fused_1d(cuda, 20_000, 4096)
    for bad in (dict(unit_tiles=9), dict(window=0), dict(window=33),
                dict(smem=100)):
        def geometry(n_tiles, n_subseq, tile, ss_max, lut, sm, bad=bad):
            geo = fd.fused_unit_geometry(1, n_tiles, tile, lut, sm)
            if "unit_tiles" in bad:
                geo = geo._replace(smem=fd.fused_unit_smem(
                    9 * 4096, args[6].numel()))
            return geo._replace(**bad)

        monkeypatch.setattr(fd, "fused_geometry", geometry)
        with pytest.raises(RuntimeError, match="CUDA error -1"):
            kernel(*args)


def test_fused_default_codec(cuda):
    """Codec(fused=True) on the card: one fused launch per tensor, no
    count_subseq on a cached plan, the two-pass bytes."""
    x = torch.from_numpy(smooth_field((40, 64, 64), seed=2)).to(cuda)
    codec = Codec(CodecConfig(fused=True))
    c = codec.compress(x)
    codec.plan_for(c)
    launches.reset()
    y = codec.decompress(c)
    counts = launches.counts()
    assert counts["decode_tiles_fused_nd"] == 1
    assert counts["decode_tiles"] == 0 and counts["count_subseq"] == 0
    assert torch.equal(y, Codec().decompress(c))


# ---------------------------------------------------------------------------
# The padded decoder and its fused epilogues, the merged-LUT tile variant,
# and the padded / tuned / batch paths of the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,noise", [
    ((20000,), 1e-4), ((30, 40, 50), 2e-3), ((300, 400), 3e-2), ((7, 9), 0)])
def test_decode_padded_matches_plain(cuda, shape, noise):
    codec, x, c = _payload(cuda, shape, 6, noise)
    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, cuda)
    args = (c.stream.units, plan.start_bits, plan.end_bits,
            c.stream.total_bits, luts.dec_sym, luts.dec_len, luts.max_len)
    before = K.decode_padded.launches
    kr, kc = K.decode_padded(*args)
    assert K.decode_padded.launches == before + 1
    pr, pc = K.decode_padded_plain(*args)
    assert torch.equal(_signed(kr), _signed(pr)) and torch.equal(kc, pc)
    codes, _ = ops.decode_padded_compact(c.stream.units, luts.dec_sym,
                                         luts.dec_len, plan.start_bits,
                                         plan.end_bits, c.stream.total_bits,
                                         luts.max_len, c.n_symbols)
    want = lorenzo.quantize_host(x, c.eb, c.radius)[0].reshape(-1)
    assert torch.equal(_signed(codes), _signed(want))


def test_decode_padded_edges_match_plain(cuda):
    """1-bit codes (the slot-127 clamp past 128 codewords in an overlong
    window) and corrupt windows, as in the plain version."""
    book, _, stream = _stream(cuda, np.array([10**6, 3, 2, 1]), 30000, 12, 1)
    rng = np.random.default_rng(5)
    nbits = stream.units.shape[0] * 32
    start = rng.integers(-300, nbits + 300, size=3000)
    end = start + rng.integers(-60, 190, size=3000)
    args = (stream.units, torch.from_numpy(start.astype(np.int32)).to(cuda),
            torch.from_numpy(end.astype(np.int32)).to(cuda),
            stream.total_bits, torch.from_numpy(book.dec_sym).to(cuda),
            torch.from_numpy(book.dec_len).to(cuda), 12)
    kr, kc = K.decode_padded(*args)
    pr, pc = K.decode_padded_plain(*args)
    assert int(kc.max()) > 128
    assert torch.equal(_signed(kr), _signed(pr)) and torch.equal(kc, pc)


def test_decode_padded_counts_and_zero_tail(cuda):
    """Windows of 0, 127, 128 and more than 128 codes (1-bit codes), n not a
    multiple of the 256-row block, written into recycled memory: every row
    equals the plain version's and is zero past its count."""
    book, _, stream = _stream(cuda, np.array([10**6, 3, 2, 1]), 30000, 12, 1)
    n = 3 * 256 + 77
    rng = np.random.default_rng(8)
    start = (128 * rng.integers(0, stream.total_bits // 128 - 2, size=n)
             + rng.integers(0, 60, size=n))
    end = start + np.array([0, 1, 127, 128, 129, 190])[np.arange(n) % 6]
    args = (stream.units, torch.from_numpy(start.astype(np.int32)).to(cuda),
            torch.from_numpy(end.astype(np.int32)).to(cuda),
            stream.total_bits, torch.from_numpy(book.dec_sym).to(cuda),
            torch.from_numpy(book.dec_len).to(cuda), 12)
    junk = torch.full((n, 128), -1, dtype=torch.int16, device=cuda)
    del junk                       # the kernel's torch.empty reuses it
    kr, kc = K.decode_padded(*args)
    pr, pc = K.decode_padded_plain(*args)
    assert torch.equal(_signed(kr), _signed(pr)) and torch.equal(kc, pc)
    assert {0, 127, 128} <= set(kc.tolist()) and int(kc.max()) > 128
    tail = (torch.arange(128, device=cuda)[None, :]
            >= kc.clamp(max=128)[:, None])
    assert bool((_signed(kr)[tail] == 0).all())


def _epilogue_call(codec, c, tile):
    """The epilogue kernel, its plain version and their arguments for the
    codes of ``c``, at tiles of ``tile`` codes (whole rows for N-D)."""
    from repro_torch.kernels import fused_decode as fd

    codes = codec.decode(c.stream, c.codebook, c.n_symbols)
    sq = ops.fused_squeeze(c.shape)
    if tile == ops.PADDED_EPILOGUE_BLOCK:
        return ops.padded_epilogue_inputs(codes, c.n_symbols, c.outlier_pos,
                                          c.outlier_val, c.eb, c.radius,
                                          c.shape, c.dtype)
    rows = None if sq is None else ops.fused_tile_rows(sq, tile)
    block = tile if sq is None else rows * sq[-1]
    pad = (-c.n_symbols) % block
    codes = torch.cat([codes, torch.zeros(pad, dtype=codes.dtype,
                                          device=codes.device)])
    ob = ops._outlier_bounds(c.outlier_pos, codes.numel() // block, block)
    two_eb = ops._two_eb_f32(c.eb)
    if sq is None:
        return fd.dequant_reconstruct, fd.dequant_reconstruct_plain, (
            codes, c.outlier_pos, c.outlier_val, ob, two_eb, c.radius, block,
            c.dtype)
    return fd.dequant_reconstruct_nd, fd.dequant_reconstruct_nd_plain, (
        codes, c.outlier_pos, c.outlier_val, ob, two_eb, c.radius, sq, rows,
        c.dtype)


EPILOGUE_CASES = {
    # 15,625 tiles of 64 codes: a long decoupled look-back
    "1d-64-code-tiles": ((1_000_000,), 64, 1e-3, 512,
                         "dequant_reconstruct"),
    # the padded path's 4,096-code tiles
    "1d-4096": ((300_001,), 4096, 1e-3, 512, "dequant_reconstruct"),
    # a flat field with most codes outliers (radius 2), at those tiles
    "1d-outlier-dense": ((300_001,), 4096, 5e-2, 2, "dequant_reconstruct"),
    # one row per tile: one row chain (2,500 units of 8)
    "2d-row-per-tile": ((20000, 64), 64, 1e-3, 512,
                        "dequant_reconstruct_nd"),
    # 200 planes of 4 tiles, 2 planes a unit
    "3d-200-planes": ((200, 32, 48), 512, 1e-3, 512,
                      "dequant_reconstruct_nd"),
    # 4 planes of 50 tiles
    "3d-4-planes": ((4, 600, 40), 512, 1e-3, 512, "dequant_reconstruct_nd"),
    # most codes are outliers, at the padded path's tiles
    "outlier-dense": ((300, 500), 4096, 5e-2, 4, "dequant_reconstruct_nd"),
    # one unit: no carry at all
    "2d-one-unit": ((7, 9), 4096, 1e-3, 512, "dequant_reconstruct_nd"),
    # more units than ring slots and resident blocks, the last one partial
    "2d-partial-group": ((20001, 64), 64, 1e-3, 512,
                         "dequant_reconstruct_nd"),
    # ring slots reused behind the gate
    "3d-ring-reuse": ((400, 64, 20), 64, 1e-3, 512,
                      "dequant_reconstruct_nd"),
    # a partial last plane group
    "3d-partial-plane-group": ((256, 100, 16), 64, 1e-3, 512,
                               "dequant_reconstruct_nd"),
    # one tile a plane: plane chains only
    "3d-one-tile-a-plane": ((50, 8, 300), 4096, 1e-3, 512,
                            "dequant_reconstruct_nd"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", list(EPILOGUE_CASES))
def test_epilogues_match_plain(cuda, case, dtype):
    shape, tile, noise, radius, name = EPILOGUE_CASES[case]
    codec, c = _fused_payload(cuda, shape, 13, noise, dtype, radius)
    kernel, plain, args = _epilogue_call(codec, c, tile)
    assert kernel.__name__ == name
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    want = plain(*args)
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    if case in ("outlier-dense", "1d-outlier-dense"):
        assert int((c.outlier_pos >= 0).sum()) > c.n_symbols // 4
    # the codec's fused padded path gives the tile two-pass bytes
    fused = Codec(codec.config.replace(strategy="padded", fused=True))
    fused.reset_stats()
    y = fused.decompress(c)
    assert fused.stats["fused_dispatches"] == 1
    assert fused.stats["fused_fallbacks"] == 0
    assert torch.equal(_bits(y), _bits(codec.decompress(c)))


@pytest.mark.parametrize("case", ["1d-64-code-tiles", "2d-row-per-tile",
                                  "3d-200-planes", "2d-partial-group",
                                  "3d-ring-reuse"])
def test_epilogue_repeated_launches_identical(cuda, case):
    shape, tile, noise, radius, _ = EPILOGUE_CASES[case]
    codec, c = _fused_payload(cuda, shape, 14, noise, torch.float32, radius)
    kernel, plain, args = _epilogue_call(codec, c, tile)
    outs = [kernel(*args) for _ in range(20)]
    want = plain(*args)
    for out in outs:
        assert torch.equal(_bits(out), _bits(want))


def test_epilogue_row_at_the_shared_memory_bound(cuda):
    """The widest row the padded fused path takes (a one-row tile of
    58,032 codes, no LUT in the block); one column more falls back."""
    import dataclasses

    from repro_torch.core.sz import compressor

    cols = compressor.FUSED_PADDED_MAX_COLS
    codec, c = _fused_payload(cuda, (3, cols), 4, 1e-3, torch.float32)
    kernel, plain, args = _epilogue_call(codec, c, ops.PADDED_EPILOGUE_BLOCK)
    assert kernel.__name__ == "dequant_reconstruct_nd" and args[7] == 1
    assert torch.equal(_bits(kernel(*args)), _bits(plain(*args)))
    assert compressor.fused_unsupported_reason(c, "cuda", "gap",
                                               "padded") is None
    wide = dataclasses.replace(c, shape=(3, cols + 1))
    assert "per-tile row bound" in compressor.fused_unsupported_reason(
        wide, "cuda", "gap", "padded")


#: The 1-D epilogue on the card, each case against its plain version with
#: every plain version made to raise while the kernel runs: (shape, tile,
#: noise, radius, look-back window).
EPILOGUE_1D_KERNEL_CASES = {
    # a window of 1 or 2 units slides on nearly every unit (64-code tiles)
    "window-1": ((300_001,), 64, 1e-3, 512, 1),
    "window-2": ((300_001,), 64, 1e-3, 512, 2),
    # units of 2 tiles of 3,001 codes: most units start off a 16-byte
    # boundary, so they are read by the threads and stored a value at a
    # time
    "unaligned-units": ((250_000,), 3001, 1e-3, 512, 32),
    # most codes outliers, in slices that span units
    "outlier-dense": ((300_001,), 4096, 5e-2, 2, 32),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", list(EPILOGUE_1D_KERNEL_CASES))
def test_epilogue_1d_kernel_cases(cuda, no_plain_versions, monkeypatch,
                                  case, dtype):
    """dequant_reconstruct launches its kernel (no plain version may run)
    and equals its plain version bit for bit, in float32, bf16 and f16."""
    from repro_torch.kernels import fused_decode as fd

    shape, tile, noise, radius, window = EPILOGUE_1D_KERNEL_CASES[case]
    geometry = fd.epilogue_geometry
    monkeypatch.setattr(fd, "epilogue_geometry",
                        lambda *a: geometry(*a)._replace(window=window))
    codec, c = _fused_payload(cuda, shape, 17, noise, dtype, radius)
    kernel, _, args = _epilogue_call(codec, c, tile)
    assert kernel.__name__ == "dequant_reconstruct"
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    monkeypatch.undo()
    want = fd.dequant_reconstruct_plain(*args)
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    if case == "outlier-dense":
        assert int((c.outlier_pos >= 0).sum()) > c.n_symbols // 4


def test_epilogue_entries_refuse_bad_geometry(cuda, monkeypatch):
    """Both 1-D epilogue C entries refuse (-1) a unit of 9 tiles, a window
    of 0 or 33, no blocks and too little shared memory, before they launch
    anything."""
    from repro_torch.kernels import fused_decode as fd

    codec, c = _fused_payload(cuda, (20_000,), 4, 1e-3, torch.float32)
    kernel, _, args = _epilogue_call(codec, c, ops.PADDED_EPILOGUE_BLOCK)
    resid = torch.zeros(20_000, dtype=torch.int32, device=cuda)
    geometry = fd.epilogue_geometry
    for bad in (dict(unit_tiles=9), dict(window=0), dict(window=33),
                dict(blocks=0), dict(smem=100)):
        def patched(*a, bad=bad):
            geo = geometry(*a)
            if "unit_tiles" in bad:
                geo = geo._replace(smem=fd.epilogue_smem(9 * 4 * a[1]))
            return geo._replace(**bad)

        monkeypatch.setattr(fd, "epilogue_geometry", patched)
        with pytest.raises(RuntimeError, match="CUDA error -1"):
            kernel(*args)
        with pytest.raises(RuntimeError, match="CUDA error -1"):
            L.reconstruct1d(resid, ops._two_eb_f32(1e-3))


ND_KERNEL_CASES = ["2d-partial-group", "3d-ring-reuse",
                   "3d-partial-plane-group", "3d-one-tile-a-plane"]


def _nd_edges(shape, tile):
    """Flat positions at the edges of the N-D kernels' units and planes
    for ``shape`` at tiles of ``tile`` codes: the first and last code of
    every unit's rows in every plane."""
    import math

    from repro_torch.kernels import fused_decode as fd

    sq = ops.fused_squeeze(shape)
    w = ops.fused_tile_rows(sq, tile)
    n = math.prod(sq)
    n_tiles = -(-n // (w * sq[-1]))
    geo = fd.nd_geometry(sq, w, n_tiles, 4096, K.sm_count(0))
    rows, cols = sq[-2], sq[-1]
    planes = sq[0] if len(sq) == 3 else 1
    unit_rows = geo.unit_tiles * w
    pos = []
    for p in range(planes):
        for r0 in range(0, rows, unit_rows):
            r1 = min(r0 + unit_rows, rows) - 1
            for r, c in ((r0, 0), (r0, cols - 1), (r1, 0), (r1, cols - 1)):
                pos.append((p * rows + r) * cols + c)
    return np.unique(np.asarray(pos))


@pytest.mark.parametrize("case", ND_KERNEL_CASES)
def test_nd_outliers_at_unit_and_plane_edges(cuda, case):
    """Spikes at the first and last codes of every unit's rows in every
    plane become outliers there (radius 4); both N-D kernels equal their
    plain versions bit for bit."""
    shape, tile, noise, _, max_len, _ = FUSED_CASES[case]
    x = smooth_field(shape, seed=21).reshape(-1)
    edges = _nd_edges(shape, tile)
    # random magnitudes and signs, so neighbouring spikes do not cancel in
    # the Lorenzo residual
    rng = np.random.default_rng(21)
    x[edges] += (rng.uniform(50, 150, edges.size) * rng.choice(
        [-1, 1], edges.size)).astype(np.float32)
    codec = Codec(CodecConfig(radius=4, max_len=max_len, device=str(cuda)))
    c = codec.compress(torch.from_numpy(x.reshape(shape)).to(cuda))
    opos = c.outlier_pos[c.outlier_pos >= 0].cpu().numpy()
    assert np.isin(edges, opos).mean() > 0.9
    kernel, plain, args = _fused_call(codec, c, tile)
    assert kernel.__name__ == "decode_tiles_fused_nd"
    assert torch.equal(_bits(kernel(*args)), _bits(plain(*args)))
    ekernel, eplain, eargs = _epilogue_call(codec, c, tile)
    assert ekernel.__name__ == "dequant_reconstruct_nd"
    assert torch.equal(_bits(ekernel(*eargs)), _bits(eplain(*eargs)))


@pytest.mark.parametrize("case", ND_KERNEL_CASES)
def test_nd_sums_wrap_int32(cuda, case):
    """Outliers of +-2**30 scattered over the field make the row, column
    and plane sums leave the int32 range again and again; the kernels'
    uint32 sums give the plain version's wrapped int32 cumsum bit for
    bit."""
    shape, tile, noise, radius, max_len, _ = FUSED_CASES[case]
    codec, c = _fused_payload(cuda, shape, 22, noise, torch.float32, radius,
                              max_len)
    kernel, plain, args = _fused_call(codec, c, tile)
    ekernel, eplain, eargs = _epilogue_call(codec, c, tile)
    n_out = c.n_symbols
    gen = torch.Generator().manual_seed(22)
    m = max(64, n_out // 50)
    pos = torch.sort(torch.randperm(n_out, generator=gen)[:m]).values
    val = torch.randint(-2**30, 2**30, (m,), generator=gen) * 2
    opos = pos.to(torch.int32).to(cuda)
    oval = val.to(torch.int32).to(cuda)
    # opos, oval, obounds are arguments 12-14 of the fused kernel and 1-3
    # of the epilogue (ops.fused_tile_inputs, padded_epilogue_inputs)
    fargs = list(args)
    block = args[9] * args[10][-1]
    ob = ops._outlier_bounds(opos, args[14].numel() - 1, block)
    fargs[12:15] = [opos, oval, ob]
    want = plain(*fargs)
    assert torch.equal(_bits(kernel(*fargs)), _bits(want))
    q = (want.double() / ops._two_eb_f32(c.eb)).round()
    assert float(q.abs().max()) > 2**29
    eargs = list(eargs)
    eob = ops._outlier_bounds(opos, eargs[3].numel() - 1,
                              eargs[7] * eargs[6][-1])
    eargs[1:4] = [opos, oval, eob]
    assert torch.equal(_bits(ekernel(*eargs)), _bits(eplain(*eargs)))



@pytest.mark.parametrize("change", ["too-few-threads", "depth-past-a-warp",
                                    "no-depth", "below-a-warp"])
def test_nd_entries_refuse_what_the_protocol_cannot_run(cuda, monkeypatch,
                                                         change):
    """A geometry whose block cannot run the look-back makes both N-D C
    entries return -1 before launching, and the wrappers raise: fewer
    threads than ring_gate's 2 x depth + 1 units (a slot could be reused
    under a reader no thread waited for), a depth past warp 0's lanes or
    of 0, a block narrower than a warp."""
    from repro_torch.kernels import fused_decode as fd

    shape, tile, noise, radius, max_len, _ = FUSED_CASES["3d-ring-reuse"]
    codec, c = _fused_payload(cuda, shape, 23, noise, torch.float32, radius,
                              max_len)
    calls = (_fused_call(codec, c, tile), _epilogue_call(codec, c, tile))
    base = fd.nd_geometry

    def geometry(*args):
        g = base(*args)
        return {"too-few-threads": g._replace(depth=32, threads=64),
                "depth-past-a-warp": g._replace(depth=33, threads=512),
                "no-depth": g._replace(depth=0),
                "below-a-warp": g._replace(depth=1, threads=16)}[change]

    monkeypatch.setattr(fd, "nd_geometry", geometry)
    for kernel, _, args in calls:
        before = kernel.launches
        with pytest.raises(RuntimeError, match="CUDA error -1"):
            kernel(*args)
        assert kernel.launches == before


def test_merged_lut_in_device_memory(cuda):
    """A merged LUT past 227 KB (20 codebooks at max_len 12, 245,760 B
    beside an 8,192-code tile) takes the tile kernel's device-memory
    variant; it equals the plain version and the one-codebook decode."""
    codec, x, c = _payload(cuda, (50000,), 7, 1e-3)
    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, cuda)
    size = 1 << luts.max_len
    slot = 13
    gen = torch.Generator().manual_seed(0)
    ds = torch.randint(0, 1024, (20 * size,), generator=gen).to(
        torch.int32).to(torch.uint16).to(cuda)
    dl = torch.randint(1, 13, (20 * size,), generator=gen).to(
        torch.uint8).to(cuda)
    ds[slot * size:(slot + 1) * size] = luts.dec_sym
    dl[slot * size:(slot + 1) * size] = luts.dec_len
    tile = 8192
    assert not K.decode_tiles_lut_in_smem(tile, ds.numel())
    base = torch.full((c.stream.n_subseq,), slot * size, dtype=torch.int32,
                      device=cuda)
    s0 = ops._tile_inputs(plan.offsets, c.stream.n_subseq, c.n_symbols, tile)
    args = (c.stream.units, plan.start_bits, plan.end_bits, plan.offsets, s0,
            c.stream.total_bits, ds, dl, luts.max_len, tile,
            hp.ss_max_for_tile(tile, luts.max_len), c.n_symbols, base)
    got = K.decode_tiles(*args)
    assert torch.equal(_signed(got), _signed(K.decode_tiles_plain(*args)))
    ref = codec.decode(c.stream, c.codebook, c.n_symbols)
    assert torch.equal(_signed(got), _signed(ref))


def test_codec_strategies_and_batch(cuda):
    """padded, padded fused, tuned and decompress_batch on the card give
    the tile two-pass bytes through their kernels; a batch of 40 tensors
    merges a LUT past shared memory and dispatches at most once a class."""
    fields = [smooth_field(s, seed=20 + i) for i, s in enumerate(
        [(40, 64, 64), (300, 500), (200000,)])]
    rng = np.random.default_rng(8)
    fields += [smooth_field((2, 8, 16, 128), seed=30 + i) + np.float32(1e-3)
               * rng.standard_normal((2, 8, 16, 128)).astype(np.float32)
               for i in range(37)]
    base = Codec()
    cs = [base.compress(torch.from_numpy(f).to(cuda)) for f in fields]
    want = [base.decompress(c) for c in cs]
    for kw, kernels in (
            (dict(strategy="padded"), ("decode_padded",)),
            (dict(strategy="padded", fused=True),
             ("decode_padded", "dequant_reconstruct",
              "dequant_reconstruct_nd")),
            (dict(strategy="tuned"), ("decode_tiles",))):
        codec = Codec(CodecConfig(**kw))
        for c in cs[:3]:
            codec.plan_for(c)
        launches.reset()
        for c, w in zip(cs[:3], want):
            assert torch.equal(codec.decompress(c), w), kw
        counts = launches.counts()
        assert all(counts[k] >= 1 for k in kernels), (kw, counts)
        assert counts["count_subseq"] == 0
    codec = Codec()
    for c in cs:
        codec.plan_for(c)
    codec.reset_stats()
    launches.reset()
    outs = codec.decompress_batch(cs)
    assert codec.stats["decode_write_dispatches"] <= codec.config.t_high + 1
    assert launches.counts()["decode_tiles"] == \
        codec.stats["decode_write_dispatches"]
    assert not K.decode_tiles_lut_in_smem(hp.OVERFLOW_TILE,
                                          len(cs) * (1 << 12))
    for y, w in zip(outs, want):
        assert torch.equal(y, w)


# ---------------------------------------------------------------------------
# The write path: lorenzo_quantize, reconstruct1d, histogram, pack_tiles
# ---------------------------------------------------------------------------


def _walk(shape, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    return x * np.float32(scale)


@pytest.mark.parametrize("radius", [512, 4])
@pytest.mark.parametrize("shape", [
    (20001,), (37, 53), (9, 31, 47), (2, 8, 16, 128), (3, 1, 5, 1, 7),
    (2, 3, 2, 3, 2, 3, 2, 3), (1,),
    # the row kernel's 1,024-value block and the tiled kernel's 8 x 128
    # tile, one below, at and one past; cesm2d's rows; a slowest axis of 1
    # after squeezing; runs of planes (13 and 37 planes over few tiles)
    (1023,), (1024,), (1025,), (7, 127), (8, 128), (9, 129), (17, 129),
    (4, 3600), (1, 17, 129), (5, 1, 16, 129), (13, 33, 260),
    (37, 20, 30)], ids=str)
def test_quantize_matches_plain(cuda, shape, radius):
    """Sizes that are no multiple of a block, unit axes, 1 to 8 axes, the
    tiled kernel's tile and plane-run edges (``quantize_geometry``), and
    outliers at radius 4."""
    x = torch.from_numpy(_walk(shape, seed=len(shape))).to(cuda)
    two_eb = ops._two_eb_f32(1e-3)
    before = L.lorenzo_quantize.launches
    got = L.lorenzo_quantize(x, two_eb, radius)
    assert L.lorenzo_quantize.launches == before + 1
    want = L.lorenzo_quantize_plain(x, two_eb, radius)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert g.shape == w.shape and torch.equal(_signed(g), _signed(w))
    if radius == 4 and x.numel() > 1:
        assert bool(got[1].any())


@pytest.mark.parametrize("shape", [(4099,), (33, 260), (9, 17, 128)],
                         ids=str)
def test_quantize_unaligned_input(cuda, shape):
    """An input 4 bytes off a 16-byte boundary (a contiguous view into a
    larger buffer): the tiled kernel loads value by value, and the outputs
    are the same."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(_walk((n + 1,), seed=n)).to(cuda)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    two_eb = ops._two_eb_f32(1e-3)
    got = L.lorenzo_quantize(x, two_eb, 512)
    for g, w in zip(got, L.lorenzo_quantize_plain(x, two_eb, 512)):
        assert torch.equal(_signed(g), _signed(w))
    aligned = L.lorenzo_quantize(x.clone(), two_eb, 512)
    for g, w in zip(got, aligned):
        assert torch.equal(_signed(g), _signed(w))


def test_quantize_tie_field(cuda):
    """The seed-0 field where the reference's Pallas quantizer flips a
    lattice tie (ROADMAP.md queue C): the kernel divides exactly."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal(20480)).astype(np.float32) * 0.1
    xt = torch.from_numpy(x).to(cuda)
    got = ops.lorenzo_quantize(xt, 1e-3, 512)
    want = lorenzo.quantize(torch.from_numpy(x), 1e-3, 512)
    for g, w in zip(got, want):
        assert torch.equal(_signed(g.cpu()), _signed(w))


def test_quantize_axis_cap_on_card(cuda):
    x = torch.zeros((2,) * 9, device=cuda)
    before = L.lorenzo_quantize.launches
    with pytest.raises(ValueError, match="at most 8 non-unit axes"):
        ops.lorenzo_quantize(x, 1e-3, 512)
    assert L.lorenzo_quantize.launches == before


@pytest.mark.parametrize("n,block", [(1, 4096), (4095, 4096), (4097, 4096),
                                     (1000003, 4096), (100000, 64)])
def test_reconstruct1d_matches_plain(cuda, n, block):
    rng = np.random.default_rng(n)
    d = torch.from_numpy(rng.integers(-600, 600, size=n).astype(
        np.int32)).to(cuda)
    two_eb = ops._two_eb_f32(1e-3)
    got = L.reconstruct1d(d, two_eb, block)
    assert torch.equal(_signed(got.view(torch.int32)),
                       L.reconstruct1d_plain(d, two_eb).view(torch.int32))


#: reconstruct1d on the card: (n, tile, residuals, look-back window, where
#: the residuals start in their buffer, in values).
RECONSTRUCT_KERNEL_CASES = {
    # past 2**24: 4,097 units, the last of 3 values
    "2**24+3": ((1 << 24) + 3, 4096, "small", 32, 0),
    # windows of 1 and 2 units slide on nearly every unit
    "window-1": (300_001, 64, "small", 1, 0),
    "window-2": (300_001, 64, "small", 2, 0),
    # units of 3,001 values: every other unit starts off a 16-byte boundary
    # of the input and the output, read by the threads and stored a value
    # at a time
    "unaligned-units": (250_000, 3001, "small", 32, 0),
    # the residuals one value into their buffer: no unit starts on a
    # 16-byte boundary of the input
    "input-offset": (300_001, 4096, "small", 32, 1),
    # residuals near +-2**31: the sums wrap int32 inside units and across
    "int32-wrap": (1_000_003, 4096, "wide", 32, 0),
}


@pytest.mark.parametrize("case", list(RECONSTRUCT_KERNEL_CASES))
def test_reconstruct1d_kernel_cases(cuda, no_plain_versions, monkeypatch,
                                    case):
    """reconstruct1d launches its kernel (no plain version may run) and
    equals its plain version bit for bit."""
    from repro_torch.kernels import fused_decode as fd

    n, tile, kind, window, offset = RECONSTRUCT_KERNEL_CASES[case]
    rng = np.random.default_rng(n + tile)
    lo, hi = (-600, 600) if kind == "small" else (-(1 << 31), 1 << 31)
    buf = torch.from_numpy(rng.integers(lo, hi, size=n + offset).astype(
        np.int32)).to(cuda)
    d = buf[offset:]
    geometry = fd.epilogue_geometry
    monkeypatch.setattr(fd, "epilogue_geometry",
                        lambda *a: geometry(*a)._replace(window=window))
    before = L.reconstruct1d.launches
    got = L.reconstruct1d(d, ops._two_eb_f32(1e-3), tile)
    assert L.reconstruct1d.launches == before + 1
    monkeypatch.undo()
    want = L.reconstruct1d_plain(d, ops._two_eb_f32(1e-3))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if kind == "wide":
        q = torch.cumsum(d, 0, dtype=torch.int64)
        assert bool(((q < -(1 << 31)) | (q >= 1 << 31)).any())


def test_quantize_reconstruct_roundtrip_on_card(cuda):
    x = torch.from_numpy(_walk((3000017,), seed=4)).to(cuda)
    eb = 1e-3
    _, _, resid = ops.lorenzo_quantize(x, eb, 512)
    y = ops.lorenzo_reconstruct(resid, eb)
    bound = eb + float(np.spacing(np.float32(float(x.abs().max()) + eb)))
    assert float((y.double() - x.double()).abs().max()) <= bound


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
@pytest.mark.parametrize("nbins", [16, 1024, 80000])
@pytest.mark.parametrize("n", [1, 1000, 1000003])
def test_histogram_matches_plain(cuda, n, nbins, dtype):
    """nbins 80000 (radius 40000) is past shared memory: the variant with
    global atomics only."""
    rng = np.random.default_rng(n + nbins)
    lo = 0 if dtype == torch.uint16 else -5
    x = torch.from_numpy(rng.integers(lo, min(nbins + 5, 65535), size=n))
    x = x.to(dtype).to(cuda)
    assert H.histogram_in_smem(nbins) == (nbins != 80000)
    before = H.histogram.launches
    got = H.histogram(x, nbins)
    assert H.histogram.launches == before + 1
    want = H.histogram_plain(x, nbins)
    assert torch.equal(got, want) and int(got.sum()) == n


def test_histogram_skewed(cuda):
    """Most codes in one bin, as on the smoke fields."""
    x = torch.full((5000000,), 512, dtype=torch.uint16, device=cuda)
    x[::7] = 511
    assert torch.equal(H.histogram(x, 1024), H.histogram_plain(x, 1024))


def _hist_case(cuda, dist, n, nbins, dtype, seed):
    rng = np.random.default_rng(seed)
    if dist == "one-bin":
        v = np.full(n, nbins // 2)
    elif dist == "uniform":
        v = rng.integers(-3 if dtype == torch.int32 else 0, nbins + 3, n)
    else:                              # the codes of a smooth field
        v = nbins // 2 + np.rint(rng.standard_normal(n) * 1.5).astype(int)
    return torch.from_numpy(v).to(dtype).to(cuda)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("n", [1, 7, 9, 4097, 32768, H.HIST_SINGLE_MAX + 1,
                               3_000_001])
def test_histogram_unaligned_views(cuda, n, offset, dtype):
    """A view that starts past a 16-byte boundary (x[1:], x[3:]): the head
    and the tail are read one value at a time, the body 16 bytes a load."""
    base = _hist_case(cuda, "skewed", n + offset, 1024, dtype, n + offset)
    x = base[offset:]
    assert x.data_ptr() % 16 != 0
    geo = H.histogram_geometry(x.data_ptr(), n, x.element_size(), 1024,
                               K.sm_count(0))
    assert geo.head + geo.vectors * 16 // x.element_size() + geo.tail == n
    got = H.histogram(x, 1024)
    assert torch.equal(got, H.histogram_plain(x, 1024))


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
@pytest.mark.parametrize("n", [H.HIST_SINGLE_MAX - 1, H.HIST_SINGLE_MAX,
                               H.HIST_SINGLE_MAX + 1, 32768])
def test_histogram_single_block_threshold(cuda, n, dtype):
    """Up to HIST_SINGLE_MAX values one block stores every bin into an
    output from torch.empty: a recycled allocation full of garbage must
    not show through."""
    single = H.histogram_geometry(0, n, 2, 1024, K.sm_count(0)).single
    assert single == (n <= H.HIST_SINGLE_MAX)
    x = _hist_case(cuda, "skewed", n, 1024, dtype, n)
    for _ in range(3):
        junk = torch.full((1024,), 0x5A5A5A5A, dtype=torch.int32,
                          device=cuda)
        del junk
        got = H.histogram(x, 1024)
        assert torch.equal(got, H.histogram_plain(x, 1024))


@pytest.mark.parametrize("nbins", [1024, 80000])
@pytest.mark.parametrize("dist", ["one-bin", "uniform", "skewed"])
@pytest.mark.parametrize("n", [32768, 5_000_000])
def test_histogram_distributions(cuda, n, dist, nbins):
    """Every code in one bin, uniform codes (with values to clip) and a
    smooth field's codes, in the shared-memory and the global-atomics
    variants (nbins 80000 is past shared memory)."""
    x = _hist_case(cuda, dist, n, nbins, torch.int32, 7)
    assert H.histogram_in_smem(nbins) == (nbins == 1024)
    before = H.histogram.launches
    got = H.histogram(x, nbins)
    assert H.histogram.launches == before + 1
    assert torch.equal(got, H.histogram_plain(x, nbins))
    assert int(got.sum()) == n


def test_histogram_widths(cuda, monkeypatch):
    """Geometries other than the rule's (block widths, grids of 1 to 264
    blocks, a grid where the rule takes one block, one block where it
    takes a grid): every one counts exactly."""
    rule = H._histogram_geometry
    x = _hist_case(cuda, "skewed", 2_000_003, 1024, torch.uint16, 3)[1:]
    want = H.histogram_plain(x, 1024)
    for threads, blocks in ((32, 1), (256, 528), (512, 264), (1024, 1),
                            (1024, 264)):
        def geometry(*key, threads=threads, blocks=blocks):
            return rule(*key)._replace(threads=threads, blocks=blocks,
                                       single=blocks == 1)

        monkeypatch.setattr(H, "_histogram_geometry", geometry)
        assert torch.equal(H.histogram(x, 1024), want)
    for n in (4097, 32768):              # a grid below the single bound
        def geometry(*key):
            return rule(*key)._replace(blocks=3, single=False)

        monkeypatch.setattr(H, "_histogram_geometry", geometry)
        assert torch.equal(H.histogram(x[:n], 1024),
                           H.histogram_plain(x[:n], 1024))


@pytest.mark.parametrize("tile_units", [1, 7, 1024, None])
@pytest.mark.parametrize("name,max_len", [("one-bit", 12), ("flat", 16),
                                          ("deep", 16), ("short", 4)])
def test_pack_tiles_matches_plain(cuda, name, max_len, tile_units):
    """min_len 1 (one-bit, deep), min_len > 1 (flat: 10 bits; short: 4),
    codewords of 16 bits (deep, a geometric distribution cut at max_len
    16), and tiles of 1, 7 and 1024 units and the geometry's own."""
    freq = {"one-bit": np.array([10**6, 3, 2, 1]),
            "flat": np.full(1024, 5),
            "deep": (2.0 ** -np.arange(40) * 2**30).astype(np.int64) + 1,
            "short": np.arange(1, 17)}[name]
    book, syms, stream = _stream(cuda, freq, 200003, max_len, 3)
    assert (book.min_len == 1) == (name in ("one-bit", "deep"))
    if name == "deep":
        assert int(book.enc_len[syms].max()) == 16
    sym = torch.from_numpy(syms.astype(np.uint16)).to(cuda)
    enc_code = torch.from_numpy(book.enc_code).to(cuda)
    enc_len = torch.from_numpy(book.enc_len).to(cuda)
    lens = enc_len.to(torch.int32)[sym.to(torch.int32)]
    starts = torch.cumsum(lens, 0, dtype=torch.int32) - lens
    n_units = stream.units.numel()
    before = E.pack_tiles.launches
    got = E.pack_tiles(sym, starts, enc_code, enc_len, n_units, tile_units)
    assert E.pack_tiles.launches == before + 1
    want = E.pack_tiles_plain(sym, starts, enc_code, enc_len, n_units)
    assert torch.equal(_signed(got), _signed(want))
    assert torch.equal(_signed(got), _signed(stream.units))


@pytest.mark.parametrize("n_syms", [1, 150, 31 * 32 // 6, 32768, 32771])
@pytest.mark.parametrize("radius", [512, 1 << 13, 1 << 15])
def test_pack_tiles_stream_sizes(cuda, n_syms, radius):
    """Streams of 1 unit, ~31 units and a KV page's ~5,760 (and three
    symbols past it, a run of 8 cut short) at the geometry's tile; tables
    in shared memory (radius 512, 2**13) and in device memory (2**15);
    the symbols and starts also 2 and 4 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(n_syms + radius)
    freq = np.bincount(rng.zipf(1.3, 50000) % 1024, minlength=1024) + 1
    book = codebook.build_codebook(freq, max_len=16)
    syms = rng.choice(1024, size=n_syms + 1, p=freq / freq.sum())
    # the table as long as the radius asks, the entries past 1024 unused
    enc_code = np.zeros(2 * radius, np.uint32)
    enc_len = np.zeros(2 * radius, np.uint8)
    enc_code[:1024] = book.enc_code
    enc_len[:1024] = book.enc_len
    enc_code = torch.from_numpy(enc_code).to(cuda)
    enc_len = torch.from_numpy(enc_len).to(cuda)
    assert E.pack_tables_in_smem(1024, enc_code.numel()) == (radius
                                                             < 1 << 15)
    for off in (0, 1):
        sym = torch.from_numpy(syms.astype(np.uint16)).to(cuda)[off:]
        sym = sym[:n_syms]
        lens = enc_len.to(torch.int32)[sym.to(torch.int32)]
        starts = torch.cumsum(lens, 0, dtype=torch.int32) - lens
        if off:
            starts = torch.cat([starts[:1], starts])[1:]
            assert sym.data_ptr() % 16 == 2 and starts.data_ptr() % 16 == 4
        n_units = -(-int(lens.sum()) // 32) + 1
        got = E.pack_tiles(sym, starts, enc_code, enc_len, n_units)
        want = E.pack_tiles_plain(sym, starts, enc_code, enc_len, n_units)
        assert torch.equal(_signed(got), _signed(want))


def test_pack_empty_and_one_symbol(cuda):
    freq = np.zeros(16, np.int64)
    freq[3] = 1
    plan = hp.build_encoder_plan(freq, max_len=8, subseqs_per_seq=32,
                                 backend="cuda", device=cuda)
    before = E.pack_tiles.launches
    empty = hp.encode_with_plan(torch.zeros(0, dtype=torch.uint16,
                                            device=cuda),
                                dataclasses.replace(plan, total_bits=0),
                                backend="cuda")
    assert empty.n_symbols == 0 and empty.total_bits == 0
    assert E.pack_tiles.launches == before
    one = torch.full((1,), 3, dtype=torch.uint16, device=cuda)
    got = hp.encode_with_plan(one, plan, backend="cuda")
    want = hp.encode_with_plan(one.cpu(), plan, backend="ref")
    assert E.pack_tiles.launches == before + 1
    for f in ("units", "gaps", "counts", "seq_counts"):
        assert torch.equal(_signed(getattr(got, f).cpu()),
                           _signed(getattr(want, f))), f


def _same_payload(a, b):
    for f in ("units", "gaps", "counts", "seq_counts"):
        assert torch.equal(_signed(getattr(a.stream, f).cpu()),
                           _signed(getattr(b.stream, f).cpu())), f
    assert a.stream.total_bits == b.stream.total_bits
    assert torch.equal(a.outlier_pos.cpu(), b.outlier_pos.cpu())
    assert torch.equal(a.outlier_val.cpu(), b.outlier_val.cpu())
    assert np.array_equal(a.codebook.enc_code, b.codebook.enc_code)
    assert np.array_equal(a.codebook.enc_len, b.codebook.enc_len)


def test_cuda_encode_codec(cuda, monkeypatch):
    """Codec(encode_backend="cuda") on CUDA tensors: one launch of each
    write-path kernel a tensor, no plain version, no fallback, the payload
    of the same compress on the CPU, decoding to the kernel's codes."""
    for name, mod in (("lorenzo_quantize_plain", L),
                      ("histogram_plain", H), ("pack_tiles_plain", E)):
        def boom(*a, _name=name, **k):
            raise AssertionError(f"{_name} ran on the card path")
        monkeypatch.setattr(mod, name, boom)
    rng = np.random.default_rng(5)
    fields = [_walk((200003,), seed=1), smooth_field((300, 500), seed=2),
              smooth_field((40, 64, 64), seed=3),
              smooth_field((2, 8, 16, 128), seed=4)]
    # noise past the radius: every field has outliers
    fields = [f + np.float32(0.05) * rng.standard_normal(f.shape).astype(
        np.float32) for f in fields]
    codec = Codec(CodecConfig(encode_backend="cuda", radius=4))
    codec.reset_stats()
    launches.reset()
    xs = [torch.from_numpy(np.ascontiguousarray(f)).to(cuda) for f in fields]
    cs = [codec.compress(x) for x in xs]
    counts = launches.counts()
    for name, n in counts.items():
        want = len(xs) if name in ("lorenzo_quantize", "histogram",
                                   "pack_tiles") else 0
        assert n == want, (name, counts)
    stats = codec.stats
    assert stats["encode_fallbacks"] == 0
    assert stats["encode_dispatches"] == len(xs)
    monkeypatch.undo()
    cpu = Codec(CodecConfig(encode_backend="cuda", radius=4, device="cpu"))
    for x, c in zip(xs, cs):
        assert c.device.type == "cuda"
        assert int((c.outlier_pos >= 0).sum()) > 0
        _same_payload(c, cpu.compress(x.cpu()))
        codes = ops.lorenzo_quantize(x, c.eb, c.radius)[0].reshape(-1)
        got = codec.decode(c.stream, c.codebook, c.n_symbols)
        assert torch.equal(_signed(got), _signed(codes))
        y = codec.decompress(c)
        assert float((y.double() - x.double()).abs().max()) <= c.eb_effective


def test_cuda_encode_lattice_matches_ref(cuda):
    eb = 0.0078125
    rng = np.random.default_rng(6)
    k = np.rint(smooth_field((30, 40, 50), seed=6) * 300).astype(np.int32)
    k.reshape(-1)[rng.choice(k.size, 9, replace=False)] += 5000
    x = torch.from_numpy(k.astype(np.float32) * np.float32(2 * eb)).to(cuda)
    dev = Codec(CodecConfig(eb=eb, mode="abs", encode_backend="cuda"))
    ref = Codec(CodecConfig(eb=eb, mode="abs"))
    _same_payload(dev.compress(x), ref.compress(x))


def test_cuda_encode_page_and_field(cuda, monkeypatch):
    """Codec(encode_backend="cuda") with every write-path plain version made
    to raise, on a KV page (4 axes: the corner-sum quantize), a 3-D field
    (the tiled quantize over runs of planes) and a 3-D lattice field with
    outliers: one launch of each write-path kernel a tensor, each payload
    decoding to its quantizer's codes, and the lattice field's payload
    byte-identical to the ref encode."""
    for name, mod in (("lorenzo_quantize_plain", L),
                      ("histogram_plain", H), ("pack_tiles_plain", E)):
        def boom(*a, _name=name, **k):
            raise AssertionError(f"{_name} ran on the card path")
        monkeypatch.setattr(mod, name, boom)
    rng = np.random.default_rng(8)
    page = smooth_field((2, 8, 16, 128), seed=8)
    field = smooth_field((37, 96, 130), seed=9)
    page = page + np.float32(1e-2) * rng.standard_normal(
        page.shape).astype(np.float32)
    field = field + np.float32(2e-3) * rng.standard_normal(
        field.shape).astype(np.float32)
    eb = 2.0 ** -7
    k = np.rint(smooth_field((20, 48, 260), seed=10) * 300).astype(np.int32)
    k.reshape(-1)[rng.choice(k.size, 9, replace=False)] += 5000
    lattice = k.astype(np.float32) * np.float32(2 * eb)
    codecs = [Codec(CodecConfig(encode_backend="cuda"))] * 2 + [
        Codec(CodecConfig(eb=eb, mode="abs", encode_backend="cuda"))]
    xs = [torch.from_numpy(np.ascontiguousarray(f)).to(cuda)
          for f in (page, field, lattice)]
    launches.reset()
    cs = [codec.compress(x) for codec, x in zip(codecs, xs)]
    for name, n in launches.counts().items():
        want = len(xs) if name in ("lorenzo_quantize", "histogram",
                                   "pack_tiles") else 0
        assert n == want, (name, n)
    monkeypatch.undo()
    for codec, x, c in zip(codecs, xs, cs):
        assert c.device.type == "cuda"
        codes = ops.lorenzo_quantize(x, c.eb, c.radius)[0].reshape(-1)
        got = codec.decode(c.stream, c.codebook, c.n_symbols)
        assert torch.equal(_signed(got), _signed(codes))
        y = codec.decompress(c)
        assert float((y.double() - x.double()).abs().max()) <= c.eb_effective
    assert int((cs[2].outlier_pos >= 0).sum()) > 0
    _same_payload(cs[2], Codec(CodecConfig(eb=eb, mode="abs")).compress(
        xs[2]))


def test_cuda_encode_float16_falls_back(cuda):
    codec = Codec(CodecConfig(encode_backend="cuda"))
    codec.reset_stats()
    launches.reset()
    x = torch.from_numpy(smooth_field((64, 64), seed=7)).to(cuda).half()
    c = codec.compress(x)
    assert codec.stats["encode_fallbacks"] == 1
    assert codec.stats["encode_dispatches"] == 0
    assert all(n == 0 for n in launches.counts().values())
    assert "float16" in compressor.encode_unsupported_reason(x, "cuda")
    _same_payload(c, Codec(CodecConfig()).compress(x))


# ---------------------------------------------------------------------------
# Self-sync: selfsync_intra, the head chaining, method="selfsync"
# ---------------------------------------------------------------------------


def _sync_stream(cuda, sps, tail):
    """A skewed stream of sps-subsequence sequences; with ``tail`` its last
    sequence holds under 400 payload bits (mostly zero padding)."""
    freq = np.bincount(np.random.default_rng(sps).zipf(1.4, 30000) % 700,
                       minlength=700)
    book = codebook.build_codebook(freq, max_len=12)
    rng = np.random.default_rng(sps + 1)
    for n in range(3000, 9000, 7):
        syms = rng.choice(700, size=n, p=freq / freq.sum())
        stream = encode.encode(torch.from_numpy(syms).to(cuda),
                               torch.from_numpy(book.enc_code).to(cuda),
                               torch.from_numpy(book.enc_len).to(cuda),
                               subseqs_per_seq=sps)
        if not tail or 0 < stream.total_bits % (128 * sps) < 400:
            return book, stream
    raise AssertionError("no mostly-padding tail found")


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("sps", [1, 3, 4, 5, 16, 31, 32, 33, 64])
def test_selfsync_intra_matches_plain(cuda, sps, early_exit, tail):
    book, stream = _sync_stream(cuda, sps, tail)
    ds = torch.from_numpy(book.dec_sym).to(cuda)
    dl = torch.from_numpy(book.dec_len).to(cuda)
    n_seq = stream.n_seq
    heads = torch.from_numpy(np.random.default_rng(sps).integers(
        0, 128, size=(n_seq, 1)).astype(np.int32)).to(cuda)
    for h in (torch.zeros_like(heads), heads):
        args = (stream.units, h, stream.total_bits, ds, dl, 12, sps,
                early_exit)
        before = S.selfsync_intra.launches
        got = S.selfsync_intra(*args)
        assert S.selfsync_intra.launches == before + 1
        want = S.selfsync_intra_plain(*args)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and torch.equal(g, w)
        assert int(got[3].max()) <= sps
        assert early_exit or bool((got[3] == sps).all())


def _random_sync_case(cuda, n_seq, sps, seed):
    """selfsync_intra's inputs over random bits: n_seq sequences of sps
    subsequences, a skewed 12-bit codebook, random heads in [0, 128) and a
    payload that ends 40 bits short of the last subsequence."""
    rng = np.random.default_rng(seed)
    freq = np.bincount(rng.zipf(1.3, 20000) % 900, minlength=900)
    book = codebook.build_codebook(freq, max_len=12)
    n_units = n_seq * sps * 4 + 2
    units = rng.integers(0, 2**32, size=n_units, dtype=np.uint64)
    heads = rng.integers(0, 128, size=(n_seq, 1)).astype(np.int32)
    return (torch.from_numpy(units.astype(np.uint32)).to(cuda),
            torch.from_numpy(heads).to(cuda), n_seq * sps * 128 - 40,
            torch.from_numpy(book.dec_sym).to(cuda),
            torch.from_numpy(book.dec_len).to(cuda), 12, sps)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("sps", [5, 32])
@pytest.mark.parametrize("blocks,extra", [(0, 1), (1, 1), (37, 3)])
def test_selfsync_intra_sequence_counts(cuda, blocks, extra, sps,
                                        early_exit):
    """n_seq = 1 and n_seq not a multiple of the sequences a block, zero
    and random heads: the warp kernel equals the plain version."""
    per_block = S.selfsync_geometry(sps, 1 << 12)[0]
    n_seq = blocks * per_block + extra
    units, heads, *rest = _random_sync_case(cuda, n_seq, sps, n_seq + sps)
    for h in (torch.zeros_like(heads), heads):
        got = S.selfsync_intra(units, h, *rest, early_exit)
        want = S.selfsync_intra_plain(units, h, *rest, early_exit)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert early_exit or bool((got[3] == sps).all())


def test_selfsync_intra_rounds_differ_within_a_block(cuda):
    """The sequences of one block stop at different rounds; each keeps the
    outputs of its own last round."""
    sps = 32
    per_block = S.selfsync_geometry(sps, 1 << 12)[0]
    args = _random_sync_case(cuda, 64 * per_block, sps, 11)
    got = S.selfsync_intra(*args, True)
    want = S.selfsync_intra_plain(*args, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rounds = got[3].reshape(-1, per_block)
    assert bool((rounds.amax(1) > rounds.amin(1)).any())


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("sps", [4, 32])
def test_selfsync_sync_matches_ref(cuda, sps, early_exit):
    """The kernel-backed sync equals the plain one and the "ref" backend's
    phases: the same counts everywhere, the same starts below total_bits
    (the two stop past the payload at other, unread positions)."""
    book, stream = _sync_stream(cuda, sps, True)
    ds = torch.from_numpy(book.dec_sym).to(cuda)
    dl = torch.from_numpy(book.dec_len).to(cuda)
    args = (stream.units, ds, dl, stream.total_bits, stream.n_subseq, sps,
            12)
    start, counts, rounds = ops.selfsync_sync(*args, early_exit=early_exit)
    cpu = [t.cpu() for t in args[:3]] + list(args[3:])
    pstart, pcounts, prounds = ops.selfsync_sync(*cpu, early_exit=early_exit)
    assert torch.equal(start.cpu(), pstart)
    assert torch.equal(counts.cpu(), pcounts)
    assert torch.equal(rounds.cpu(), prounds)
    rstart, rcounts = hp.get_backend("ref").sync_fn(*cpu, early_exit)
    assert torch.equal(counts.cpu(), rcounts)
    assert torch.equal(counts, stream.counts)
    below = rstart < stream.total_bits
    assert torch.equal(start.cpu()[below], rstart[below])


def test_codec_selfsync_paths(cuda):
    """Every decode path with method="selfsync" on the card gives the gap
    two-pass bytes, through selfsync_intra and never count_subseq."""
    fields = [smooth_field(s, seed=40 + i) for i, s in enumerate(
        [(40, 64, 64), (300, 500), (200000,)])]
    base = Codec()
    cs = [base.compress(torch.from_numpy(f).to(cuda)) for f in fields]
    want = [base.decompress(c) for c in cs]
    for kw, kernels in (
            (dict(), ("decode_tiles",)),
            (dict(fused=True), ("decode_tiles_fused",
                                "decode_tiles_fused_nd")),
            (dict(strategy="padded"), ("decode_padded",)),
            (dict(strategy="padded", fused=True),
             ("decode_padded", "dequant_reconstruct",
              "dequant_reconstruct_nd")),
            (dict(strategy="tuned"), ("decode_tiles",))):
        codec = Codec(CodecConfig(method="selfsync", **kw))
        launches.reset()
        for c, w in zip(cs, want):
            assert torch.equal(codec.decompress(c), w), kw
        counts = launches.counts()
        assert all(counts[k] >= 1 for k in kernels), (kw, counts)
        assert counts["selfsync_intra"] >= len(cs), (kw, counts)
        assert counts["count_subseq"] == 0, (kw, counts)
    codec = Codec(CodecConfig(method="selfsync"))
    outs = codec.decompress_batch(cs)
    for y, w in zip(outs, want):
        assert torch.equal(y, w)
    for early_exit in (True, False):
        for c in cs:
            got = Codec(CodecConfig(method="selfsync", strategy="padded")
                        ).decode(c.stream, c.codebook, c.n_symbols,
                                 early_exit=early_exit)
            assert torch.equal(got, base.decode(c.stream, c.codebook,
                                                c.n_symbols))


# ---------------------------------------------------------------------------
# The model kernels: flash_attention and gla_time_mix
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import rwkv_gla as GLA  # noqa: E402
from repro_torch.testing import kernel_cases as KC  # noqa: E402


@pytest.fixture
def full_f32_matmul():
    """The plain versions' float32 products in full float32 (no TF32), the
    card's default, stated and restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", KC.FLASH_CASES, ids=lambda c: c[0])
def test_flash_attention_matches_plain(cuda, full_f32_matmul, case, dtype):
    """float32: within 2e-5 (the sums run in another order); bfloat16: the
    kernel rounds p to bf16 for its tensor-core P V product (a term moves
    by at most 2**-9 of |v|) and both round the output once, so within one
    bf16 ulp of the output's scale.  The window cases: rows that see no
    key in their block's first tile give no NaN."""
    q, k, v = KC.flash_inputs(case, dtype, cuda)
    kw = KC.flash_kwargs(case)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, **kw)
    assert FA.flash_attention.launches == before + 1
    ref = FA.flash_attention_plain(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    err = (out.double() - ref.double()).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    else:
        assert err <= KC.bf16_ulp(ref.float().abs().max().item()), err
    again = FA.flash_attention(q, k, v, **kw)
    assert torch.equal(out, again)


def test_flash_attention_scale_and_extreme_logits(cuda, full_f32_matmul):
    q = torch.full((1, 64, 16), 30.0, device=cuda)
    k = torch.full((1, 64, 16), 30.0, device=cuda)
    v = torch.ones((1, 64, 16), device=cuda)
    out = FA.flash_attention(q, k, v, causal=True)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-5,
                               atol=0)
    q, k, v = KC.flash_inputs(KC.FLASH_CASES[5], torch.float32, cuda)
    out = FA.flash_attention(q * 0.125, k, v, causal=True, scale=1.0)
    ref = FA.flash_attention_plain(q, k, v, causal=True, scale=0.125)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_window_at_danube_shape(cuda, full_f32_matmul,
                                                dtype):
    """h2o-danube's layer shape (D 80, GQA 4) cut to 2 heads and 1,100
    tokens, window 512: the kernel skips the tiles below the window and
    agrees with its plain version; a window of at least Skv equals no
    window, bit for bit; a fully masked row raises."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((8, 1100, 80), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, 1100, 80), generator=gen, device=cuda).to(dtype)
            for _ in "kv")
    out = FA.flash_attention(q, k, v, causal=True, window=512)
    ref = FA.flash_attention_plain(q, k, v, causal=True, window=512)
    assert bool(torch.isfinite(out).all())
    tol = (2e-5 if dtype == torch.float32
           else KC.bf16_ulp(ref.float().abs().max().item()))
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert torch.equal(FA.flash_attention(q, k, v, causal=True, window=1100),
                       FA.flash_attention(q, k, v, causal=True))
    with pytest.raises(ValueError, match="sees no key"):
        FA.flash_attention(q, k, v, causal=True, q_offset=-1)


def test_decode_attn_int8_on_card(cuda, full_f32_matmul):
    """decode_attn_int8 on the card against the CPU, 40 steps of the
    reduced danube's attention (ring buffer of 32, wrapping).  The int8
    products are exact in float32 on both; the projections' float32 sums
    run in another order, so a key a rounding away from a half-way point
    may take the next code: the codes equal at all but a thousandth and
    within one, the scales within 1e-6 relative, the output within 1e-3
    (a code one off moves its key or value by a quantization step)."""
    from repro_torch import configs
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(
        configs.get_config("h2o-danube-1.8b").reduced(
            compute_dtype="float32"), kv_quant=True)
    p = T.init_model(0, cfg, "cpu")["layers"][0]["attn"]
    pc = {k: t.to(cuda) for k, t in p.items()}
    shape = (2, 32, cfg.n_kv_heads, cfg.head_dim)
    caches = [{"k": torch.zeros(shape, dtype=torch.int8, device=dev),
               "v": torch.zeros(shape, dtype=torch.int8, device=dev),
               "k_scale": torch.zeros(shape[:3], device=dev),
               "v_scale": torch.zeros(shape[:3], device=dev)}
              for dev in ("cpu", cuda)]
    gen = torch.Generator().manual_seed(6)
    for pos in range(40):
        x = torch.randn((2, 1, cfg.d_model), generator=gen)
        a, _ = A.decode_attn_int8(x, p, cfg, caches[0], pos, window=32)
        b, _ = A.decode_attn_int8(x.to(cuda), pc, cfg, caches[1], pos,
                                  window=32)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3, atol=1e-3)
    for name in ("k", "v"):
        d = (caches[1][name].cpu().int() - caches[0][name].int()).abs()
        assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel()
    for name in ("k_scale", "v_scale"):
        torch.testing.assert_close(caches[1][name].cpu(), caches[0][name],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", KC.GLA_CASES, ids=lambda c: c[0])
def test_gla_time_mix_matches_plain(cuda, case):
    """float32 both; the state sums run in another order: 1e-4 of the
    output's scale."""
    r, k, v, w, u, state = KC.gla_inputs(case, cuda)
    before = GLA.gla_time_mix.launches
    y, st = GLA.gla_time_mix(r, k, v, w, u, state)
    assert GLA.gla_time_mix.launches == before + 1
    py, pst = GLA.gla_time_mix_plain(r, k, v, w, u, state)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    for got, want in ((y, py), (st, pst)):
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * scale, (err, scale)
    if state is not None:
        zero = torch.zeros_like(state)
        y0, _ = GLA.gla_time_mix(r, k, v, w, u, zero)
        y1, _ = GLA.gla_time_mix(r, k, v, w, u, None)
        assert torch.equal(y0, y1)


def test_model_kernels_refuse_not_fall_back(cuda):
    """A CUDA tensor the kernels do not take raises; nothing launches and
    nothing falls back to a plain version."""
    q = torch.zeros((2, 8, 32), device=cuda)
    f0, g0 = FA.flash_attention.launches, GLA.gla_time_mix.launches
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="up to"):
        big = torch.zeros((2, 8, 256), device=cuda)
        FA.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    with pytest.raises(ValueError, match="BH"):
        FA.flash_attention(q, q[:1].expand(3, 8, 32).contiguous(), q[:1]
                           .expand(3, 8, 32).contiguous())
    r = torch.zeros((4, 5, 64), device=cuda)
    u = torch.zeros((2, 64), device=cuda)
    with pytest.raises(TypeError):
        GLA.gla_time_mix(r.bfloat16(), r.bfloat16(), r.bfloat16(),
                         r.bfloat16(), u.bfloat16())
    with pytest.raises(ValueError, match="u must be"):
        GLA.gla_time_mix(r, r, r, r, torch.zeros((3, 64), device=cuda))
    with pytest.raises(ValueError, match="dk"):
        wide = torch.zeros((4, 5, 200), device=cuda)
        GLA.gla_time_mix(wide, wide, r, wide,
                         torch.zeros((2, 200), device=cuda))
    assert FA.flash_attention.launches == f0
    assert GLA.gla_time_mix.launches == g0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b"])
def test_model_forward_and_decode_on_card(cuda, full_f32_matmul, arch):
    """A reduced model in float32 on the card against the same weights on
    the CPU: the forward through the kernel (one launch a layer) and eight
    decode steps, within 1e-4 of the logits' scale."""
    from repro_torch import configs
    from repro_torch.models import decode as D
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T

    cfg = configs.get_config(arch).reduced(compute_dtype="float32")
    params = T.init_model(0, cfg, cuda)
    cpu = {k: ([{g: ({n: t.cpu() for n, t in d.items()}
                     if isinstance(d, dict) else d.cpu())
                 for g, d in lp.items()} for lp in v]
               if k == "layers" else v.cpu()) for k, v in params.items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40)))
    kernel = FA.flash_attention if cfg.family == "dense" else \
        GLA.gla_time_mix
    launches.reset()
    got = St.make_prefill_step(cfg)(params, toks.to(cuda))
    assert kernel.launches == cfg.n_layers
    want = St.make_prefill_step(cfg)(cpu, toks)
    scale = max(1.0, want.abs().max().item())
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * scale
    cache, ccache = D.init_cache(cfg, 2, 8, cuda), D.init_cache(cfg, 2, 8,
                                                                "cpu")
    serve = St.make_serve_step(cfg)
    launches.reset()
    for t in range(8):
        lg, cache = serve(params, toks[:, t:t + 1].to(cuda), cache, t)
        clg, ccache = serve(cpu, toks[:, t:t + 1], ccache, t)
        assert (lg.cpu() - clg).abs().max().item() <= 1e-4 * scale
    assert GLA.gla_time_mix.launches == (8 * cfg.n_layers
                                         if cfg.family == "rwkv" else 0)
    assert FA.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# cuSZ's chunked baseline (decode_chunked), the store and the KV pager
# ---------------------------------------------------------------------------


def _chunk_book(max_len: int, n: int, seed: int):
    """A codebook at ``max_len`` whose LUT has 2**max_len entries, and ``n``
    symbols drawn uniformly from its used symbols (so its long codes
    occur)."""
    k = 2 if max_len == 1 else 40 if max_len > 12 else 300
    freq = np.maximum(1, (1e7 * 0.6 ** np.arange(k))).astype(np.int64)
    book = codebook.build_codebook(freq, max_len=max_len)
    syms = np.random.default_rng(seed).integers(0, k, n)
    return book, syms


def _chunked_args(cuda, max_len, chunk, n, seed=0):
    from repro_torch.core.huffman import encode as he

    book, syms = _chunk_book(max_len, n, seed)
    ch = he.encode_chunked(torch.from_numpy(syms).to(cuda), book.enc_code,
                           book.enc_len, chunk)
    luts = hp._as_luts(book, cuda)
    return syms, (ch["units"], ch["chunk_bits"], ch["chunk_syms"],
                  luts.dec_sym, luts.dec_len, max_len, chunk)


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_decode_chunked_every_block_width(cuda, monkeypatch, threads):
    """Each block width the geometry can choose decodes the same bits,
    with a ragged last block."""
    from repro_torch.kernels import huffman_chunked as HC

    syms, args = _chunked_args(cuda, 12, 512, 300 * 512 + 5)
    want = HC.decode_chunked(*args)
    geometry = HC.decode_chunked_geometry

    def forced(n_chunks, lut, sm):
        _, _, smem = geometry(n_chunks, lut, sm)
        return -(-n_chunks // threads), threads, smem

    monkeypatch.setattr(HC, "decode_chunked_geometry", forced)
    got = HC.decode_chunked(*args)
    assert torch.equal(_signed(got), _signed(want))
    assert np.array_equal(_signed(got).reshape(-1)[:len(syms)].cpu().numpy(),
                          syms)


@pytest.mark.parametrize("chunk,n", [(1, 3001), (2048, 20 * 2048 + 77),
                                     (16384, 3 * 16384 + 1001)])
@pytest.mark.parametrize("max_len", [1, 12, 17, 24])
def test_decode_chunked_matches_plain(cuda, max_len, chunk, n):
    """The kernel equals its plain version (run on the CPU copies) bit for
    bit, zeros included, with the LUT in shared memory (max_len 1, 12) and
    in device memory (17, 24), at chunk sizes 1, 2,048 and 16,384 with a
    ragged last chunk; its first n codes are the symbols."""
    from repro_torch.kernels import huffman_chunked as HC

    assert HC.decode_chunked_lut_in_smem(1 << max_len) == (max_len <= 16)
    syms, args = _chunked_args(cuda, max_len, chunk, n)
    before = HC.decode_chunked.launches
    got = HC.decode_chunked(*args)
    torch.cuda.synchronize()
    assert HC.decode_chunked.launches == before + 1
    assert got.device.type == "cuda" and got.shape == (-(-n // chunk), chunk)
    want = HC.decode_chunked_plain(*[a.cpu() if isinstance(a, torch.Tensor)
                                     else a for a in args])
    assert torch.equal(_signed(got).cpu(), _signed(want))
    assert np.array_equal(_signed(got).reshape(-1)[:n].cpu().numpy(), syms)


def test_decode_chunked_entry_refuses(cuda):
    """The C entry refuses (-1) a max_len outside 1-24, no chunks, a block
    that is not 1-8 whole warps, a grid with fewer threads than chunks,
    and a shared-memory LUT that the given shared memory cannot hold or
    Hopper cannot give, before it launches anything."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import huffman_chunked as HC

    _, (units, bits, _, ds, dl, max_len, chunk) = _chunked_args(
        cuda, 12, 2048, 10_000)
    n = units.shape[0]
    out = torch.empty((n, chunk), dtype=torch.uint16, device=cuda)
    launch = _build.load("decode_chunked")
    stream = torch.cuda.current_stream().cuda_stream

    def call(max_len=max_len, n_chunks=n, global_lut=0, blocks=n,
             threads=32, smem=HC.decode_chunked_smem(1 << max_len)):
        return launch(units.data_ptr(), n_chunks, units.shape[1],
                      bits.data_ptr(), ds.data_ptr(), dl.data_ptr(), max_len,
                      chunk, global_lut, blocks, threads, smem,
                      out.data_ptr(), stream)

    assert call() == 0
    torch.cuda.synchronize()
    for bad in (dict(max_len=0), dict(max_len=25), dict(n_chunks=0),
                dict(threads=48), dict(threads=16), dict(threads=512),
                dict(blocks=0), dict(blocks=-(-n // 64) - 1, threads=64),
                dict(smem=100), dict(smem=300_000)):
        assert call(**bad) == -1, bad
    with pytest.raises(ValueError, match="max_len"):
        HC.decode_chunked(units, bits, torch.zeros_like(bits, dtype=torch.int32),
                          ds, dl, 25, chunk)


def test_decode_chunked_never_falls_back(cuda, monkeypatch):
    """``core.huffman.decode.decode_chunked`` on CUDA tensors launches the
    kernel with its plain version made to raise."""
    from repro_torch.kernels import huffman_chunked as HC

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran for a CUDA tensor")

    monkeypatch.setattr(HC, "decode_chunked_plain", refuse)
    syms, args = _chunked_args(cuda, 12, 16384, 40_000)
    got = hd.decode_chunked(*args)
    assert np.array_equal(_signed(got).reshape(-1)[:40_000].cpu().numpy(),
                          syms)


@pytest.fixture
def no_encode_plain_versions(monkeypatch):
    """The write path's plain versions raise if called: a "cuda" compress
    of a CUDA tensor must launch its kernels."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran for a CUDA tensor")

    for mod, name in ((L, "lorenzo_quantize_plain"), (H, "histogram_plain"),
                      (E, "pack_tiles_plain")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("max_len", [12, 20])
def test_store_read_on_card(cuda, tmp_path, no_plain_versions, max_len):
    """An archive written from the card reads back through iter_decode on
    the card (count_subseq and decode_tiles, plain versions raising) bit
    for bit against decompress_batch, at max_len 12 and 20 (the LUTs read
    from device memory); a bfloat16 chunk comes back as bfloat16; a warm
    reopen builds zero plans and hits the codebook cache; zero_fill yields
    bfloat16 zeros of the recorded shape on the card."""
    from repro_torch.core.cache import PlanCache
    from repro_torch.store import Archive, ArchiveWriter

    codec = Codec(CodecConfig(device=str(cuda), max_len=max_len),
                  plan_cache=PlanCache())
    xs = {f"t{i}": torch.from_numpy(smooth_field((48, 40 + 9 * i),
                                                 seed=i)).to(cuda)
          for i in range(5)}
    cs = {n: codec.compress(x) for n, x in xs.items()}
    path = str(tmp_path / "card.szt")
    with ArchiveWriter(path) as w:
        for n, c in cs.items():
            w.add(n, c, "bfloat16" if n == "t4" else None)
    want = dict(zip(cs, codec.decompress_batch(list(cs.values()))))
    # A reader with its own plan cache: the writer's codec holds the plans.
    codec = Codec(CodecConfig(device=str(cuda), max_len=max_len),
                  plan_cache=PlanCache())
    launches.reset()
    with Archive(path, codec=codec) as ar:
        got = ar.read_all(group_chunks=2)
    assert K.count_subseq.launches > 0 and K.decode_tiles.launches > 0
    for n in cs:
        assert got[n].device.type == "cuda"
        if n == "t4":
            assert got[n].dtype == torch.bfloat16
            assert torch.equal(got[n], want[n].to(torch.bfloat16))
        else:
            assert torch.equal(got[n], want[n])
    codec.reset_stats()
    with Archive(path, codec=codec) as ar:
        again = ar.read_all()
    assert codec.stats["plan_builds"] == 0
    assert codec.stats["lut_hits"] >= 1
    assert all(torch.equal(again[n], got[n]) for n in cs)
    with Archive(path, codec=codec) as ar:
        rec_off = ar.chunk("t4").units.offset
    with open(path, "r+b") as f:
        f.seek(rec_off)
        f.write(b"\xff\xff\xff\xff")
    with Archive(path, codec=codec) as ar:
        z = ar.read_all(policy="zero_fill")["t4"]
    assert z.dtype == torch.bfloat16 and z.device.type == "cuda"
    assert tuple(z.shape) == tuple(xs["t4"].shape) and not z.any()


def test_kv_pager_on_card(cuda, tmp_path, no_plain_versions,
                          no_encode_plain_versions):
    """KVPager over a bfloat16 cache on the card with a "cuda" codec: the
    offload launches the write path's kernels, zeroes the span in place,
    page_in restores it within the bf16-cast bound, and a repeat page-in
    builds zero plans."""
    from repro_torch.core.cache import PlanCache
    from repro_torch.store import KVPager

    gen = torch.Generator(device=cuda).manual_seed(0)
    base = torch.cumsum(torch.randn((2, 2, 64, 2, 16), generator=gen,
                                    device=cuda) * 0.05, dim=2)
    cache = {"k": base.to(torch.bfloat16),
             "v": (base + 0.5).to(torch.bfloat16)}
    orig = {n: t.clone() for n, t in cache.items()}
    codec = Codec(CodecConfig(encode_backend="cuda", device=str(cuda)),
                  plan_cache=PlanCache())
    pager = KVPager(str(tmp_path), codec=codec)
    launches.reset()
    cache, bid = pager.offload(cache, 16, 48)
    assert L.lorenzo_quantize.launches == 2 and E.pack_tiles.launches == 2
    assert not cache["k"][:, :, 16:48].any()
    assert torch.equal(cache["k"][:, :, 48:], orig["k"][:, :, 48:])
    cache = pager.page_in(cache, bid)
    assert K.decode_tiles.launches > 0
    for n in ("k", "v"):
        c = codec.compress(orig[n][:, :, 16:48].float())
        bound = dataclasses.replace(c, dtype=torch.bfloat16).eb_effective
        err = (cache[n].float() - orig[n].float()).abs().max().item()
        assert err <= bound, (n, err, bound)
    codec.reset_stats()
    pager.page_in(cache, bid)
    assert codec.stats["plan_builds"] == 0 and pager.stats["pages_in"] == 2


# ---------------------------------------------------------------------------
# Checkpoints, the serving scheduler and the fault campaign on the card
# ---------------------------------------------------------------------------


def test_checkpoint_restore_on_card_equals_ref(cuda, tmp_path,
                                               no_plain_versions):
    """One checkpoint (float32 and bfloat16 leaves over and under the size
    floor, an int32 scalar) restored on the card through the kernels and
    on the CPU by "ref": bit for bit, the card's leaves on the card; a
    raw bfloat16 leaf comes back as bfloat16."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.cache import PlanCache

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.from_numpy(smooth_field((96, 80), seed=1)),
              "layers": {"b": torch.randn((24,), generator=g),
                         "h": torch.from_numpy(smooth_field(
                             (4096,), seed=2)).to(torch.bfloat16),
                         "s": torch.randn((5, 3), generator=g).to(
                             torch.bfloat16)},
              "n": torch.tensor(3, dtype=torch.int32)}
    ref = Codec(CodecConfig(backend="ref"), plan_cache=PlanCache())
    CheckpointManager(str(tmp_path), codec=ref,
                      compress_min_size=1024).save(1, params)
    want = CheckpointManager(str(tmp_path), codec=ref).restore()["params"]
    card = Codec(CodecConfig(device=str(cuda)), plan_cache=PlanCache())
    launches.reset()
    got = CheckpointManager(str(tmp_path), codec=card).restore()["params"]
    assert K.count_subseq.launches > 0 and K.decode_tiles.launches > 0

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{p}{k}.")
        else:
            yield p[:-1], t

    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want) == ["layers.b", "layers.h",
                                           "layers.s", "n", "w"]
    for k, w in want.items():
        assert got[k].device.type == "cuda" and got[k].dtype == w.dtype, k
        assert torch.equal(got[k].cpu(), w), k
    assert got["layers.s"].dtype == torch.bfloat16


def test_sharded_checkpoint_on_card(cuda, tmp_path, no_plain_versions,
                                    no_encode_plain_versions):
    """A mesh-sharded checkpoint written on the card ("cuda" encode, a
    {data: 4, model: 2} layout, 3 shards) restores on the card through the
    kernels bit for bit as "ref" restores it on the CPU, and into a
    one-rank "cuda" mesh as DTensors; the gradient sync over that mesh's
    NCCL group equals the same call over gloo on the CPU, bit for bit."""
    from types import SimpleNamespace

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.cache import PlanCache
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import collectives

    g = torch.Generator().manual_seed(0)
    params = {"attn": {"wq": torch.randn((256, 8, 32), generator=g)},
              "mlp": {"wd": torch.randn((512, 128), generator=g)},
              "embed": torch.from_numpy(smooth_field((640, 96), seed=3)),
              "norm": torch.randn((96,), generator=g)}
    layout = SimpleNamespace(shape={"data": 4, "model": 2},
                             axis_names=("data", "model"))
    writer = Codec(CodecConfig(device=str(cuda), encode_backend="cuda"),
                   plan_cache=PlanCache())
    launches.reset()
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    CheckpointManager(str(tmp_path), codec=writer, compress_min_size=4096
                      ).save(1, on_card, mesh=layout, shard_count=3)
    assert L.lorenzo_quantize.launches > 0 and E.pack_tiles.launches > 0
    ref = Codec(CodecConfig(backend="ref"), plan_cache=PlanCache())
    want = CheckpointManager(str(tmp_path), codec=ref).restore()["params"]
    card = Codec(CodecConfig(device=str(cuda)), plan_cache=PlanCache())
    launches.reset()
    got = CheckpointManager(str(tmp_path), codec=card).restore()["params"]
    assert K.count_subseq.launches > 0 and K.decode_tiles.launches > 0
    try:
        mesh = make_host_mesh()
        on_mesh = CheckpointManager(str(tmp_path), codec=card).restore(
            mesh=mesh)["params"]
        for path in (("attn", "wq"), ("mlp", "wd"), ("embed",), ("norm",)):
            a, b, d = got, want, on_mesh
            for p in path:
                a, b, d = a[p], b[p], d[p]
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b), path
            assert isinstance(d, DTensor) and torch.equal(d.to_local(), a)
        x = torch.randn((3, 1000), generator=g) * 1e-3
        sync, init = collectives.make_dp_gradient_sync(mesh, eb=1e-7)
        csync, cinit = collectives.make_dp_gradient_sync(
            make_host_mesh(device_type="cpu"), eb=1e-7)
        out, res = sync({"x": x.to(cuda)}, init({"x": x.to(cuda)}))
        cout, cres = csync({"x": x}, cinit({"x": x}))
        assert torch.equal(out["x"].cpu(), cout["x"])
        assert torch.equal(res["x"].cpu(), cres["x"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("overlap", [True, False])
def test_scheduler_on_card(cuda, tmp_path, no_plain_versions, overlap):
    """The serving scheduler on the card, staging on its own stream with
    overlap: many sessions' requests, each block equal to ``pager.fetch``
    bit for bit, every distinct block decoded once, with and without the
    overlap (which then runs on one stream)."""
    from repro_torch.core.cache import PlanCache
    from repro_torch.serving import DecodeScheduler
    from repro_torch.store import KVPager

    codec = Codec(CodecConfig(device=str(cuda)), plan_cache=PlanCache())
    pager = KVPager(str(tmp_path), codec=codec)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cache = {n: torch.cumsum(torch.randn((4, 1, 96, 2, 64), generator=gen,
                                         device=cuda) * 0.05, dim=2)
             for n in ("k", "v")}
    ids = [pager.offload(cache, lo, lo + 16)[1] for lo in range(0, 96, 16)]
    direct = {bid: pager.fetch(bid) for bid in ids}
    with DecodeScheduler(pager, batch_window_s=0.001,
                         overlap=overlap) as sched:
        assert (sched._stage_stream is not None) == overlap
        futs = [(bid, sched.submit(sid, bid)) for sid in range(8)
                for bid in ids[sid % 3:]]
        for bid, f in futs:
            for n, t in f.result().items():
                assert t.device.type == "cuda"
                assert torch.equal(t, direct[bid][n]), (bid, n)
        stats = dict(sched.stats)
    assert stats["blocks_decoded"] == len(ids)
    assert stats["requests"] == len(futs)
    assert stats["prefix_hits"] + stats["coalesced_requests"] == \
        len(futs) - len(ids)


def test_fault_campaign_on_card(cuda, tmp_path):
    """24 cases of the seed-0 campaign with every decode on the card
    (corrupt streams, gap arrays, outlier lists and tables handed to the
    kernels): zero silent, unnamed or hanging cases, and the context stays
    usable after them."""
    from repro_torch.testing import run_campaign

    report = run_campaign(seed=0, cases=24, backend="cuda",
                          base_dir=str(tmp_path / "campaign"))
    assert report.ok, report.summary()
    assert {r.case.consumer for r in report.results} == \
        {"store", "decode", "checkpoint", "paging"}
    x = torch.arange(8, device=cuda, dtype=torch.float32)
    assert float(x.sum()) == 28.0


# ---------------------------------------------------------------------------
# Training: the trainable functions and a train step on the card
# ---------------------------------------------------------------------------


def _autograd(fn, inputs, cotangents, **kw):
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in inputs]
    out = fn(*leaves, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o.float() * c).sum() for o, c in zip(outs, cotangents)).backward()
    return [t.grad for t in leaves if t is not None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", KC.FLASH_CASES, ids=lambda c: c[0])
def test_flash_trainable_gradients_on_card(cuda, full_f32_matmul, case,
                                           dtype):
    """dq, dk, dv of flash_attention_trainable (the kernel forward, one
    launch) against autograd through the plain version: within one bf16
    ulp of each gradient's scale in bfloat16 (both compute in float32 and
    round once), 1e-4 of it in float32."""
    q, k, v = KC.flash_inputs(case, dtype, cuda)
    cot = [torch.randn((q.shape[0], q.shape[1], v.shape[2]), device=cuda)]
    kw = KC.flash_kwargs(case)
    before = FA.flash_attention.launches
    got = _autograd(FA.flash_attention_trainable, (q, k, v), cot, **kw)
    assert FA.flash_attention.launches == before + 1
    want = _autograd(FA.flash_attention_plain, (q, k, v), cot, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        scale = float(w.float().abs().max())
        tol = KC.bf16_ulp(scale) if dtype == torch.bfloat16 else 1e-4 * scale
        assert float((g.float() - w.float()).abs().max()) <= tol


@pytest.mark.parametrize("case", KC.GLA_CASES, ids=lambda c: c[0])
def test_gla_trainable_gradients_on_card(cuda, case):
    """The six gradients of gla_time_mix_trainable (the kernel a 64-step
    chunk forward) against autograd through the plain recurrence, within
    1e-4 of each gradient's scale."""
    args = KC.gla_inputs(case, cuda)
    r, v = args[0], args[2]
    cot = [torch.randn((r.shape[0], r.shape[1], v.shape[2]), device=cuda),
           torch.randn((r.shape[0], r.shape[2], v.shape[2]), device=cuda)]
    before = GLA.gla_time_mix.launches
    got = _autograd(GLA.gla_time_mix_trainable, args, cot)
    assert GLA.gla_time_mix.launches == before + -(-r.shape[1] // GLA.CHUNK)
    want = _autograd(GLA.gla_time_mix_plain, args, cot)
    assert len(got) == len(want) == (6 if args[5] is not None else 5)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b"])
def test_train_step_on_card_matches_cpu(cuda, full_f32_matmul, arch):
    """One reduced train step (float32 compute) on the card and on the CPU
    from the same parameters and batch: the loss within 1e-5 relative,
    every gradient within 1e-4 of its leaf's scale, every updated
    parameter within a quarter of the learning rate.  A gradient cut at a
    kernel would move the projections' updates by about lr."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as O

    cfg = configs.get_config(arch).reduced(compute_dtype="float32")
    ocfg = O.AdamWConfig(lr=1e-3)
    cpu = T.init_model(0, cfg, "cpu")
    card = O.tree_map(lambda t: t.to(cuda), cpu)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=48,
                                   global_batch=4), device="cpu").batch_at(0)
    kernel = FA.flash_attention if cfg.family == "dense" else \
        GLA.gla_time_mix
    before = kernel.launches
    (lg, _), gg = St.grads_of(card, {k: v.to(cuda) for k, v in
                                     batch.items()}, cfg)
    assert kernel.launches > before
    (lc, _), gc = St.grads_of(cpu, batch, cfg)
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(O.tree_leaves(gg), O.tree_leaves(gc)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    ng, _, mg = St.make_train_step(cfg, ocfg)(
        card, O.init(card, ocfg), {k: v.to(cuda) for k, v in batch.items()})
    nc, _, mc = St.make_train_step(cfg, ocfg)(cpu, O.init(cpu, ocfg), batch)
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= \
        1e-5 * float(mc["grad_norm"])
    for a, b in zip(O.tree_leaves(ng), O.tree_leaves(nc)):
        assert float((a.cpu() - b).abs().max()) <= 0.25 * ocfg.lr


def test_train_main_preempts_and_resumes_on_card(cuda, tmp_path, capsys):
    """launch/train.py on the card: --preempt-at 3 exits 17, a rerun
    resumes from the compressed step 3 (restore through count_subseq and
    decode_tiles)."""
    from repro_torch.launch import train

    base = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "32", "--ckpt-every", "2", "--log-every", "1",
            "--ckpt-compress-eb", "1e-4", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        train.main(base + ["--preempt-at", "3"])
    assert e.value.code == 17
    launches.reset()
    first, last = train.main(base)
    assert "resumed from step 3" in capsys.readouterr().out
    assert K.count_subseq.launches > 0 and K.decode_tiles.launches > 0
    assert np.isfinite(first) and np.isfinite(last)
