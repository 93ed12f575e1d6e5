#!/usr/bin/env python3
"""A traced run of a cell, with the program's spans reduced and read.

    python3 portbench/span_report.py --workload <cell> --seed <n> \
        [--seconds 3] [--out <file.json>]

Runs the cell as ``run.py --trace 1`` runs it (``harness.run_cell``), with
the trace summary also carrying ``spans.reduce`` of the window: the
program's spans (``spans``) and the harness's (``harness_spans``).  The
cell reports the metrics that read the spans (``SPAN_METRICS``) beside its
own.  Prints one JSON line: the result, each span name's ``n``,
``host_s``, ``self_s``, ``device_s`` and ``idle_s`` a read, and the share of
the device's idle time inside the reads (the harness's per-read spans) that
falls under a span of the program; ``--out`` writes the whole reduction.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
#: The per-layer entries of the metrics that read the program's spans.
SPAN_METRICS = [
    {"name": name, "unit": unit, "better": better, "source": "program_span",
     "layer": layer, "moves": "decompress_GBps",
     "workloads": ["hurricane.read_once", "hurricane.reread"]}
    for name, unit, better, layer in (
        ("host_syncs_per_read", "syncs/read", "lower", "codec session"),
        ("h2d_uploads_per_read", "uploads/read", "lower", "codec session"),
        ("host_wait_ms", "ms", "lower", "codec session"),
        ("dequantize_ms", "ms", "lower", "decode and dequantize"),
        ("huffman_decode_GBps", "GB/s", "higher", "huffman decode"))]
#: The program's root spans: every other span of a read nests in one.
ROOTS = "repro_torch.session."
#: The harness's spans around each read of a traced window.
READ_SPANS = ("portbench.plan", "portbench.decode", "portbench.read")


def with_span_metrics(bench: dict, workload: str) -> dict:
    """``bench`` whose cell ``workload`` also reports ``SPAN_METRICS``."""
    bench = dict(bench)
    bench["per_layer"] = bench["per_layer"] + [
        dict(e, workloads=[workload]) for e in SPAN_METRICS]
    return bench


def summarize(summary: dict, ops: int) -> dict:
    """Each span a read, and the idle share inside the reads under them."""
    per_read = {name: {k: v / ops for k, v in row.items()}
                for name, row in sorted(summary["spans"].items())}
    in_reads = sum(row["idle_s"] for name, row
                   in summary["harness_spans"].items() if name in READ_SPANS)
    under = sum(row["idle_s"] for row in summary["spans"].values())
    roots = sum(row["device_s"] for name, row in summary["spans"].items()
                if name.startswith(ROOTS))
    return {"spans_per_read": per_read,
            "device_under_roots_share": (roots / summary["busy_s"]
                                         if summary["busy_s"] else None),
            "idle_in_reads_s": in_reads,
            "idle_under_program_s": under,
            "idle_under_program_share": under / in_reads if in_reads else None}


def report(workload: str, seed: int, seconds: float, **run_kw) -> dict:
    """One traced run of ``workload`` (``run_kw`` as ``harness.run_cell``
    takes them); returns the printed report, with the whole reduction
    under ``trace`` and the run's result under ``result``."""
    from portbench import harness, spans, tracing

    stock, kept = tracing.reduce, {}

    def reduce(events, window_us):
        kept.update(stock(events, window_us))
        kept["spans"] = spans.reduce(events, window_us)
        kept["harness_spans"] = spans.reduce(events, window_us,
                                             prefix="portbench.")
        return kept

    tracing.reduce = reduce
    try:
        bench = with_span_metrics(harness.load_benchmark(), workload)
        result = harness.run_cell(workload, seed, seconds, True, bench=bench,
                                  **run_kw)
    finally:
        tracing.reduce = stock
    return {"workload": workload, "seed": seed, "correct": result["correct"],
            "reads": result["attempted"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "busy_s": kept["busy_s"], "window_s": kept["window_s"],
            **summarize(kept, result["attempted"]), "trace": kept,
            "result": result}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    torch.set_num_threads(1)
    r = report(args.workload, args.seed, args.seconds, t0=T0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(r, indent=1))
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("trace", "result")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
