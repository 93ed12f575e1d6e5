#!/usr/bin/env python
"""Run a seeded fault-injection campaign against every decode consumer of
the PyTorch port (``repro_torch``).

The CLI of ``tools/faultinject.py`` over ``repro_torch.testing``.  Every
injected corruption -- archive bit-flips, truncations, torn checkpoint
manifests, mangled in-memory ``Compressed`` fields, lost KV blocks,
transient IO errors -- must be *detected* (a named error), *recovered*
(policy salvage with the degradation reported), *contained* (bounded
garbage, right shape, no crash), or provably inert (*bit_exact*).  Silent
wrong data, hangs, and unnamed exceptions fail the run.

``--backend ref`` (the default) decodes with torch ops on the CPU;
``--backend cuda`` runs the corpus and every decode on the card, where the
decode channel hands corrupt streams to the CUDA kernels.

Usage:
  PYTHONPATH=src python tools/faultinject_torch.py --seed 0 --cases 200
  PYTHONPATH=src python tools/faultinject_torch.py --cases 24 --backend cuda -v

Exit status 0 iff zero violations.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded corruption campaign over store / decode / "
                    "checkpoint / KV-paging consumers of the port")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=200)
    ap.add_argument("--backend", default="ref", choices=["ref", "cuda"],
                    help="decode backend under test (ref: the CPU; cuda: "
                         "the card)")
    ap.add_argument("--dir", default=None,
                    help="corpus directory (default: fresh temp dir)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-case watchdog seconds; exceeding it is a "
                         "'hang' violation")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every case as it completes")
    args = ap.parse_args(argv)

    from repro_torch.testing import run_campaign

    t0 = time.time()

    def progress(i, r):
        if args.verbose or not r.ok:
            mark = "ok " if r.ok else "XXX"
            print(f"[{mark}] case {i:4d} {r.case.consumer}/{r.case.kind} "
                  f"seed={r.case.seed} -> {r.outcome}: {r.note}",
                  flush=True)

    report = run_campaign(seed=args.seed, cases=args.cases,
                          base_dir=args.dir, backend=args.backend,
                          timeout=args.timeout, progress=progress)
    print(report.summary())
    print(f"elapsed {time.time() - t0:.1f}s "
          f"(seed {args.seed}, backend {args.backend})")
    if report.violations:
        print(f"FAIL: {len(report.violations)} invariant violation(s):")
        for r in report.violations:
            print(f"  {r.case.consumer}/{r.case.kind} seed={r.case.seed}: "
                  f"{r.outcome}: {r.note}")
        return 1
    print("OK: every injected fault was detected, recovered, contained, "
          "or inert")
    return 0


if __name__ == "__main__":
    sys.exit(main())
