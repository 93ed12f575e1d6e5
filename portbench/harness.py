"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the fields and the codec's fixed settings) and a traffic mix
(``mixes/<name>.*``, read by ``traffic.py``).  Each metric the cell
reports is a reader of its own, ``metrics/<name>.py``, with one function
``read(m)`` over the measurements ``m`` that this module gathers; it
returns a number or None when it finds nothing to read.  So a cell, a mix
or a metric is added by adding files and entries, not by editing this one.

The run:

* set-up: the configuration's fields are made on the device from the
  seed; a read mix compresses each once through the port and reads each
  once (kernels loaded, payload digests memoized, plans cached where the
  mix keeps them); a write mix compresses each once;
* the window: a closed loop of one client over the fields, one operation
  at a time, each timed from the call to a ``torch.cuda.synchronize()``,
  for ``seconds``; with ``trace`` the profiler records a window of at
  most ``TRACE_SECONDS``, and a read is split into the benchmark's two
  spans (``plan_for``, then ``decompress`` with that plan), which is what
  ``Codec.decompress`` runs;
* the check, once the window has closed and the peak memory is read: the
  last output of every field held against the plain reference
  (``judge.py``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from portbench import accounting, fields, judge, traffic, tracing

HERE = Path(__file__).resolve().parent
#: Longest traced window, in seconds.
TRACE_SECONDS = 3.0
ROOT = HERE.parent


def load_benchmark(path: "Path | None" = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in bench['workloads']]}")


def metric_entries(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a cell reports: end-to-end without trace, per-layer
    with it; an entry with ``workloads`` only in the cells it lists."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [e for e in entries if workload in e.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    import importlib.util

    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"metric {name!r}: no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_codec(config: dict, mix: dict, device):
    from repro_torch.core.codec import Codec, CodecConfig

    settings = dict(config["codec"])
    if mix.get("plan_cache_size") is not None:
        settings["plan_cache_size"] = int(mix["plan_cache_size"])
    return Codec(CodecConfig(device=str(device), **settings))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: "float | None" = None, device="cuda", shape=None,
             program=None, bench: "dict | None" = None) -> dict:
    """One run; returns the result line's object (``checks`` last).

    ``device``, ``shape`` (in place of the configuration's field shape)
    and ``program`` (``program(codec, op)`` -> the operation the window
    times, for the control and the planted faults) serve the tests and
    ``control.py``; a benchmark run passes none of them.
    """
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or load_benchmark()
    cell = find_cell(bench, workload)
    config = load_config(cell["config"])
    mix = traffic.load(cell["traffic"])
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shape = tuple(config["shape"] if shape is None else shape)
    n_fields = int(config["fields"])
    amp = float(config["assumed"]["noise_amp"])
    noise = config["assumed"]["noise"]
    eb_rel = float(config["codec"]["eb"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # ---- set-up -----------------------------------------------------------
    marks = [("start", time.perf_counter())]
    codec = build_codec(config, mix, device)
    op_kind = mix["op"]
    stock = {"read": lambda c: codec.decompress(c),
             "write": lambda x: codec.compress(x)}[op_kind]
    op = program(codec, op_kind) if program is not None else stock
    originals = [fields.make(shape, amp, seed, i, device, noise)
                 for i in range(n_fields)]
    _sync(device)
    marks.append(("fields", time.perf_counter()))
    held = ([codec.compress(x) for x in originals] if op_kind == "read"
            else originals)
    _sync(device)
    marks.append(("compress", time.perf_counter()))
    originals = None                # a reader holds only the compressed
    # Warm-up: every field once through the timed operation.  A field the
    # window never reaches is checked on its warm-up output.
    kept: dict = {}
    footprints = []
    for f, item in enumerate(held):
        out = op(item)
        footprints.append(accounting.footprint(
            item if op_kind == "read" else out))
        kept[f] = out
        del out
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    print("portbench set-up: imports and CUDA start %.2f s, " % (
        marks[0][1] - t0) + ", ".join(
        "%s %.2f s" % (name, t - marks[i][1])
        for i, (name, t) in enumerate(marks[1:])), file=sys.stderr)

    # ---- the window -------------------------------------------------------
    gc.collect()
    gc.freeze()           # set-up's objects stay out of the window's sweeps
    rounds = traffic.order(n_fields, seed)
    lat, spans = [], {"plan": [], "decode": []}
    failed = 0
    first_error = None
    stats0 = dict(codec.stats)
    prof = tracing.profiler() if trace else None
    if prof is not None:
        prof.start()
    # A traced window is shorter: the profiler's trace of a long one takes
    # minutes to read back.
    window = min(seconds, TRACE_SECONDS) if trace else seconds
    w0 = time.perf_counter()
    # Spans mark the trace; an untraced window opens none.
    span = (torch.profiler.record_function if trace
            else lambda name: contextlib.nullcontext())
    with span("portbench.window"):
        i = 0
        while True:
            f = rounds[i % n_fields]
            i += 1
            t = time.perf_counter()
            try:
                if trace and op_kind == "read" and program is None:
                    with span("portbench.plan"):
                        plan = codec.plan_for(held[f])
                        _sync(device)
                    t1 = time.perf_counter()
                    with span("portbench.decode"):
                        out = codec.decompress(held[f], plan=plan)
                        _sync(device)
                    spans["plan"].append(t1 - t)
                    spans["decode"].append(time.perf_counter() - t1)
                else:
                    with span(f"portbench.{op_kind}"):
                        out = op(held[f])
                        _sync(device)
            except Exception:        # counted and reported, the loop goes on
                failed += 1
                first_error = first_error or traceback.format_exc()
                out = None
            lat.append(time.perf_counter() - t)
            kept[f] = out
            if time.perf_counter() - w0 >= window:
                break
            del out
    elapsed = time.perf_counter() - w0
    gc.unfreeze()
    stats1 = dict(codec.stats)
    trace_summary = None
    if prof is not None:
        prof.stop()
        events = prof.events()
        win = [e for e in events if e.name == "portbench.window"][0]
        trace_summary = tracing.reduce(
            events, (win.time_range.start, win.time_range.end))
        del events, prof
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # ---- the check --------------------------------------------------------
    del codec, held
    checks = judge.judge(op_kind, kept, range(n_fields),
                         lambda f: fields.make(shape, amp, seed, f, device,
                                               noise), eb_rel)
    if first_error:
        print(first_error, file=sys.stderr)
    correct = failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values())

    # ---- the metrics ------------------------------------------------------
    n_vals = 1
    for s in shape:
        n_vals *= int(s)
    m = {"op": op_kind, "ops": len(lat), "elapsed_s": elapsed,
         "latencies_s": lat, "bytes_per_op": 4 * n_vals,
         "setup_s": setup_s, "ratio": accounting.ratio(footprints),
         "spans": spans, "plan_builds": stats1.get("plan_builds", 0)
         - stats0.get("plan_builds", 0), "trace": trace_summary,
         "least_bytes_per_op": sum(accounting.least_bytes(fp)
                                   for fp in footprints) / len(footprints),
         "peaks": accounting.peaks(accounting.device_kind(device))}
    metrics = {}
    for entry in metric_entries(bench, workload, trace):
        value = reader(entry["name"])(m)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": accounting.device_kind(device), "count": 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(lat),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_summary is not None:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {k: trace_summary[k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    return result
