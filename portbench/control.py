#!/usr/bin/env python3
"""The readings that set the limits of ``correct``, on the card.

    python3 portbench/control.py --workload <cell> --seconds 2 \
        --sound 1 2 3 ... --control 21 22 23

For each ``--sound`` seed, one run of the cell as the benchmark runs it;
for each ``--control`` seed, one run with the control in the program's
place: the plain reference computed one precision below the
configuration's float32, bfloat16.

* A read cell's control decodes each stored stream with the plain decoder
  and dequantizes with a bfloat16 product.
* A write cell's control is the port's own lower-precision path: it
  compresses the field cast to bfloat16.

Prints one JSON line a run with its compared numbers.  The benchmark's
runs never run the control; the tests run it at a size a CPU holds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_program(codec, op):
    """The control in the place of the timed operation ``op``."""
    import torch

    from portbench.reference import huffman, lattice

    if op == "write":
        return lambda x: codec.compress(x.to(torch.bfloat16))

    def read(c):
        s, book = c.stream, c.codebook
        codes, _ = huffman.decode(s.units, s.gaps, int(s.total_bits),
                                  int(s.n_symbols), book.enc_code,
                                  book.enc_len, int(book.max_len))
        return lattice.dequantize(codes, c.outlier_pos, c.outlier_val, c.eb,
                                  c.shape, c.radius, compute=torch.bfloat16)
    return read


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sound", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness

    for kind, seeds in (("sound", args.sound), ("control", args.control)):
        for seed in seeds:
            t = time.perf_counter()
            r = harness.run_cell(
                args.workload, seed, args.seconds, False,
                program=control_program if kind == "control" else None)
            print(json.dumps({"workload": args.workload, "run": kind,
                              "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"],
                              "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
