#!/usr/bin/env python3
"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA devices of this machine
(``harness.py``), prints the compared numbers beside their limits as the
last lines of standard error, and one JSON object as the last line of
standard output.  Exits non-zero without a result when PyTorch sees too
few CUDA devices for the cell, or when the JAX package or JAX itself has
been imported into this process by the time the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that must not be loaded: JAX, its libraries and
#: the JAX package of this repository (``repro``; ``repro_torch`` is the
#: port, so names are compared whole).
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FOREIGN))


#: One process with few threads: the window is one client's loop, and idle
#: OpenMP, MKL and OpenBLAS pools only add threads that share the host's
#: cores with it.  Set before numpy or torch is first imported.
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_name] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Every cache the program builds stays inside the checkout, at fixed
    # paths: the kernels' libraries go to build/kernels (fixed by the
    # program), Triton's cache, should any kernel use it, to build/triton.
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), PyTorch sees {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=T0, bench=bench)
    found = foreign_modules()
    if found:
        print(f"portbench: the process loaded {found}; the port must run "
              f"without JAX and without the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
