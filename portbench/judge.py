"""How ``correct`` is decided: the window's outputs against the reference.

Every compared number is printed beside its limit.

* A read returns the field's dual-quant lattice (``reference/lattice.py``)
  bit for bit: ``lattice_mismatch`` counts the values that differ, limit 0.
  That covers the Huffman decode (one wrong code moves every later value
  of the Lorenzo sum), the dequantize and the inverse Lorenzo.
* ``err_over_bound`` is ``max|x - x'|`` over the bound the configuration
  states, ``eb * range`` plus two float32 ulps at ``max|x|``: limit 1.
* A write is judged by the stream it wrote: the plain decoder
  (``reference/huffman.py``) reads it; ``stream_faults`` counts breaks,
  unknown codewords and a wrong symbol count, limit 0; the decoded codes,
  dequantized by the plain inverse, are then held to the two numbers
  above.

``x`` is the original field, made again from the seed after the window.
"""

from __future__ import annotations

import torch

from portbench.reference import huffman, lattice


def _bound_numbers(x, xr, eb_rel):
    eb = lattice.abs_eb(x, eb_rel)
    ref = lattice.lattice(x, eb)
    bad = lattice.mismatches(xr, ref)
    del ref
    return bad, lattice.max_error(x, xr) / lattice.guarantee(x, eb)


def decoded_field(c, shape):
    """The field a compressed output holds, read by the plain decoder:
    ``(float32 field or None, stream faults)``."""
    s, book = c.stream, c.codebook
    codes, faults = huffman.decode(s.units, s.gaps, int(s.total_bits),
                                   int(s.n_symbols), book.enc_code,
                                   book.enc_len, int(book.max_len))
    n = 1
    for d in shape:
        n *= int(d)
    if codes.numel() != n or tuple(c.shape) != tuple(shape):
        return None, faults + 1
    return lattice.dequantize(codes, c.outlier_pos, c.outlier_val, c.eb,
                              shape, c.radius), faults


def judge(op: str, outputs: dict, checked, make_field,
          eb_rel: float) -> dict:
    """The compared numbers of one run, each with its limit."""
    bad, worst, faults = 0, 0.0, 0
    for f in checked:
        out = outputs.get(f)
        x = make_field(f)
        if out is None:
            bad += x.numel()
            worst = float("inf")
            continue
        if op == "write":
            out, n_faults = decoded_field(out, x.shape)
            faults += n_faults
            if out is None:
                bad += x.numel()
                worst = float("inf")
                continue
        b, w = _bound_numbers(x, out, eb_rel)
        bad += b
        worst = max(worst, w)
        del x, out
        outputs[f] = None
    checks = {}
    if op == "write":
        checks["stream_faults"] = {"value": faults, "limit": 0}
    checks["lattice_mismatch"] = {"value": bad, "limit": 0}
    checks["err_over_bound"] = {"value": worst, "limit": 1.0}
    return checks
