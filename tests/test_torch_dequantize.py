"""The two-pass dequantize's two paths (``compressor._dequantize``).

On the card a tensor the padded epilogue takes is reconstructed by one
launch of ``dequant_reconstruct_nd`` (2-D/3-D after the unit axes are
squeezed) or ``dequant_reconstruct`` (1-D); every other tensor, and every
tensor on the CPU, runs ``lorenzo.dequantize``'s torch ops.  The decode
backend owns the choice: "cuda" registers the epilogue as its
``dequant_fn``, "ref" registers none and stays plain torch.  Here, on the
CPU: the shared eligibility helper ``reconstruct_unsupported_reason`` at its
edges, the padded strategy's fused check asking the same helper, the
backends' ops, and the epilogues' plain versions over exactly the inputs
``_dequantize`` builds for the kernel, bit for bit against
``lorenzo.dequantize`` -- ragged last tiles, ``-1`` padding and positions
at or past the end, which both drop.
The kernels themselves are held to the same on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import trace
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor, lorenzo
from repro_torch.data.pipeline import smooth_field
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import launches, ops

COLS = compressor.FUSED_PADDED_MAX_COLS
PLANE = compressor.FUSED_MAX_PLANE

#: shape, dtype -> the reason ``reconstruct_unsupported_reason`` gives.
EDGES = {
    "cols-at-bound": ((3, COLS), torch.float32, None),
    "cols-past-bound": ((3, COLS + 1), torch.float32,
                        f"fastest axis {COLS + 1} exceeds the per-tile row "
                        f"bound {COLS}"),
    "plane-at-bound": ((2, 1024, 1024), torch.float32, None),
    "plane-past-bound": ((2, 1024, 1025), torch.float32,
                         f"plane 1024x1025 exceeds the VMEM plane-carry "
                         f"bound {PLANE}"),
    "4-D": ((2, 3, 4, 5), torch.bfloat16,
            "4-D Lorenzo reconstruction (fused epilogue covers up to 3-D)"),
    "float64": ((40, 50), torch.float64,
                "dtype float64 not in fused set ('float32', 'bfloat16', "
                "'float16')"),
    "unit-axes-squeezed-to-3-D": ((1, 2, 1, 3, 4, 1), torch.float16, None),
    "unit-axes-past-bound": ((1, 3, 1, COLS + 1), torch.float32,
                             f"fastest axis {COLS + 1} exceeds the per-tile "
                             f"row bound {COLS}"),
    "1-D": ((1_000_003,), torch.bfloat16, None),
}


def _payload(shape, dtype=torch.float32, radius=512, noise=1e-3, seed=4):
    rng = np.random.default_rng(seed)
    x = smooth_field(shape, seed=seed) + np.float32(noise) * \
        rng.standard_normal(shape).astype(np.float32)
    codec = Codec(CodecConfig(radius=radius, device="cpu"))
    c = codec.compress(torch.from_numpy(x).to(dtype))
    return c, codec.decode(c.stream, c.codebook, c.n_symbols)


@pytest.mark.parametrize("case", list(EDGES))
def test_reconstruct_bound_at_the_edges(case):
    shape, dtype, want = EDGES[case]
    assert compressor.reconstruct_unsupported_reason(shape, dtype) == want


@pytest.mark.parametrize("case", list(EDGES))
def test_padded_fused_check_asks_the_same_helper(case):
    """The padded strategy's fused check and the card's two-pass dequantize
    take exactly the same shapes and dtypes."""
    shape, dtype, want = EDGES[case]
    c, _ = _payload((4, 6))
    c = dataclasses.replace(c, shape=shape, dtype=dtype)
    for backend in ("cuda", "ref"):
        assert compressor.fused_unsupported_reason(
            c, backend, "gap", "padded") == want


#: shape, dtype, radius, noise; the epilogue each shape takes.
CASES = {
    # 5,000 codes in two 4,096-code tiles: the last tile ragged
    "1-D-ragged": ((5000,), torch.float32, 512, 1e-3, fd.dequant_reconstruct),
    # tiles of 81 rows of 50: 300 rows leave a ragged last tile
    "2-D-ragged": ((300, 50), torch.float32, 512, 1e-3,
                   fd.dequant_reconstruct_nd),
    "3-D-bf16": ((6, 14, 33), torch.bfloat16, 512, 1e-3,
                 fd.dequant_reconstruct_nd),
    "3-D-f16": ((5, 20, 24), torch.float16, 512, 1e-3,
                fd.dequant_reconstruct_nd),
    # most codes are outliers
    "2-D-radius-2": ((60, 70), torch.float32, 2, 5e-2,
                     fd.dequant_reconstruct_nd),
    "1-D-radius-2": ((3000,), torch.bfloat16, 2, 5e-2,
                     fd.dequant_reconstruct),
    "unit-axes-to-2-D": ((1, 40, 1, 50), torch.float32, 512, 1e-3,
                         fd.dequant_reconstruct_nd),
    "unit-axes-to-1-D": ((3, 1), torch.float16, 512, 1e-3,
                         fd.dequant_reconstruct),
}


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_epilogue_matches_torch_dequantize(case):
    shape, dtype, radius, noise, kernel = CASES[case]
    c, codes = _payload(shape, dtype, radius, noise)
    m = int((c.outlier_pos >= 0).sum())
    assert m < c.outlier_pos.numel()            # -1 padding at the tail
    if radius == 2:
        assert m > c.n_symbols // 4
    # Two positions past the end, ascending behind the real ones: one in
    # the last tile's pad (or in no tile), one past every tile.
    n = c.n_symbols
    opos = torch.cat([c.outlier_pos[:m],
                      torch.tensor([n, n + 3 * ops.PADDED_EPILOGUE_BLOCK],
                                   dtype=torch.int32),
                      c.outlier_pos[m:]])
    oval = torch.cat([c.outlier_val[:m],
                      torch.tensor([1 << 20, -(1 << 20)], dtype=torch.int32),
                      c.outlier_val[m:]])
    for pos, val in ((c.outlier_pos, c.outlier_val), (opos, oval)):
        got_kernel, plain, args = ops.padded_epilogue_inputs(
            codes.reshape(-1), n, pos, val, c.eb,
            c.radius, c.shape, c.dtype)
        assert got_kernel is kernel
        got = plain(*args)[:n].reshape(c.shape)
        want = lorenzo.dequantize(codes.reshape(c.shape), pos, val, c.eb,
                                  c.shape, radius=c.radius, dtype=c.dtype)
        assert got.dtype == want.dtype == dtype
        assert torch.equal(_bits(got), _bits(want)), case
    if case.endswith("ragged"):
        assert args[0].numel() > n              # padded to whole tiles


@pytest.mark.parametrize("shape,dtype", [((40, 50), torch.float32),
                                         ((2, 3, 4, 5), torch.float32),
                                         ((30, 40), torch.float64)])
def test_cpu_reads_take_the_torch_path(monkeypatch, shape, dtype):
    """Off the card every tensor runs ``lorenzo.dequantize`` and launches
    nothing; the span says so."""
    seen = []
    stock = trace.span

    def span(name, args=None):
        if name == "repro_torch.dequantize":
            seen.append(args)
        return stock(name, args)

    monkeypatch.setattr(trace, "span", span)
    c, codes = _payload(shape, dtype)
    launches.reset()
    got = Codec(CodecConfig(device="cpu")).decompress(c)
    batch = Codec(CodecConfig(device="cpu")).decompress_batch([c, c])
    assert seen == ["torch"] * 3
    assert all(n == 0 for n in launches.counts().values())
    want = lorenzo.dequantize(codes.reshape(shape), c.outlier_pos,
                              c.outlier_val, c.eb, c.shape, radius=c.radius,
                              dtype=dtype)
    for y in (got, *batch):
        assert y.dtype == dtype and torch.equal(y, want)


def test_backends_own_the_dequantize_op():
    """"cuda" dequantizes through the epilogue op; "ref" registers none, so
    its reads stay plain torch on every device."""
    assert hp.get_backend("cuda").dequant_fn is ops.dequant_epilogue
    assert hp.get_backend("ref").dequant_fn is None


@pytest.mark.parametrize("backend", ["cuda", "ref", "recording"])
def test_cpu_reads_never_call_the_backend_op(monkeypatch, backend):
    """A backend's ``dequant_fn`` runs only on the card: a CPU read through
    any backend, one whose op records its calls too, runs the torch ops."""
    calls = []
    if backend == "recording":
        backend = dataclasses.replace(
            hp.get_backend("cuda"), name="recording",
            dequant_fn=lambda *args: calls.append(args))
    c, codes = _payload((30, 40))
    want = lorenzo.dequantize(codes.reshape(c.shape), c.outlier_pos,
                              c.outlier_val, c.eb, c.shape, radius=c.radius,
                              dtype=c.dtype)
    got = compressor.decompress(c, backend=backend)
    batch = compressor.decompress_batch([c], backend=backend)
    assert calls == []
    assert torch.equal(got, want) and torch.equal(batch[0], want)
