"""The program's spans reduced (``spans.reduce``), on hand-built traces and
on a traced run, and the readers of the span metrics.

A span the program opens is mirrored on the device's timeline as an
annotation: neither reduction counts it as the card's work, so
``busy_s`` (``device_idle_pct.read``, ``decompress_roofline_pct``) is
what the device's own events give.
"""

import dataclasses

import pytest
from torch.autograd import DeviceType

from portbench import harness, span_report, spans, tracing

US = 1e-6


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    name: str
    start: float
    end: float
    device_type: DeviceType = DeviceType.CPU
    id: int = 0
    thread: int = 1
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return Range(self.start, self.end)


def _kernel(cid, lo, hi):
    return Event(f"kernel_{cid}", lo, hi, DeviceType.CUDA, id=cid)


def _trace():
    """A read in a 100 us window: a root over a decode with phase 4
    inside it, then a dequantize; four launches and their kernels, one
    launched outside every span; the decode's annotation on the device's
    timeline."""
    cpu = [Event("repro_torch.session.decompress", 10, 60, id=1),
           Event("repro_torch.decode", 15, 40, id=2),
           Event("repro_torch.decode.phase4", 20, 30, id=3),
           Event("repro_torch.dequantize", 45, 58, id=4),
           Event("aten::cumsum", 46, 49, id=5),
           Event("cudaLaunchKernel", 22, 23, id=101),
           Event("cudaLaunchKernel", 47, 48, id=102),
           Event("cudaMemcpyAsync", 16, 17, id=103),
           Event("cudaLaunchKernel", 70, 71, id=104)]
    device = [_kernel(101, 25, 35), _kernel(102, 50, 65),
              _kernel(103, 33, 38), _kernel(104, 72, 80)]
    note = Event("repro_torch.decode", 24, 45, DeviceType.CUDA, id=2,
                 is_user_annotation=True)
    return cpu, device, note


def test_hand_built_trace():
    cpu, device, note = _trace()
    got = spans.reduce(cpu + device + [note], (0, 100))
    want = {  # n, host, self, device (launched inside, merged), idle
        "repro_torch.session.decompress": (1, 50, 12, 28, 10),
        "repro_torch.decode": (1, 25, 15, 13, 7),
        "repro_torch.decode.phase4": (1, 10, 10, 10, 5),
        "repro_torch.dequantize": (1, 13, 13, 15, 5)}
    assert set(got) == set(want)
    for name, (n, host, own, dev, idle) in want.items():
        row = got[name]
        assert row["n"] == n
        for key, value in (("host_s", host), ("self_s", own),
                           ("device_s", dev), ("idle_s", idle)):
            assert row[key] == pytest.approx(value * US), (name, key)


@pytest.mark.parametrize("flagged", [True, False])
def test_annotations_are_no_device_work(flagged):
    """The annotation, flagged or known by its name, leaves the spans'
    device and idle times as the device's own events give them; flagged,
    as every profiler the benchmark has met flags it, it leaves the busy
    time of ``tracing.reduce`` too, and so ``device_idle_pct.read`` and
    ``decompress_roofline_pct``."""
    cpu, device, note = _trace()
    note.is_user_annotation = flagged
    with_note = spans.reduce(cpu + device + [note], (0, 100))
    assert with_note == spans.reduce(cpu + device, (0, 100))
    if flagged:
        got = tracing.reduce(cpu + device + [note], (0, 100))
        assert got == tracing.reduce(cpu + device, (0, 100))
        assert got["busy_s"] == pytest.approx((13 + 15 + 8) * US)


def test_spans_clip_to_the_window_and_skip_other_prefixes():
    cpu, device, _ = _trace()
    harness_spans = [Event("portbench.decode", 5, 62),
                     Event("portbench.window", 0, 100)]
    got = spans.reduce(cpu + device + harness_spans, (30, 100))
    assert "repro_torch.decode.phase4" not in got
    assert got["repro_torch.decode"]["host_s"] == pytest.approx(10 * US)
    outer = spans.reduce(cpu + device + harness_spans, (0, 100),
                         prefix="portbench.")
    assert set(outer) == {"portbench.decode", "portbench.window"}
    # Idle inside the read: 0-5 and 62-72, 80-100 lie under the window.
    assert outer["portbench.decode"]["idle_s"] == pytest.approx(
        (20 + 12) * US)
    assert outer["portbench.decode"]["device_s"] == pytest.approx(28 * US)


def _m(span_rows, ops=4, op="read", trace=True):
    summary = {"busy_s": 1.0, "window_s": 2.0, "spans": span_rows}
    return {"op": op, "ops": ops, "bytes_per_op": 4_000_000,
            "trace": summary if trace else None}


ROWS = {"repro_torch.plan.gap.sync": {"n": 4, "host_s": 0.4e-3},
        "repro_torch.plan.counts.sync": {"n": 4, "host_s": 0.8e-3},
        "repro_torch.plan.luts.h2d": {"n": 4, "host_s": 0.4e-3},
        "repro_torch.dequantize.eb.h2d": {"n": 4, "host_s": 1.6e-3},
        "repro_torch.decode.phase4": {"n": 4, "host_s": 1e-3,
                                      "device_s": 3e-4},
        "repro_torch.plan": {"n": 4, "host_s": 4e-3, "device_s": 1e-4},
        "repro_torch.dequantize": {"n": 4, "host_s": 4e-3,
                                   "device_s": 2.8e-3}}
READS = {"host_syncs_per_read": 2.0, "h2d_uploads_per_read": 2.0,
         "host_wait_ms": 0.8, "dequantize_ms": 0.7,
         "huffman_decode_GBps": 4 * 2e6 / 4e-4 / 1e9}


@pytest.mark.parametrize("name", list(READS))
def test_span_readers(name):
    read = harness.reader(name)
    assert read(_m(ROWS)) == pytest.approx(READS[name])
    # Nothing to read: a program without spans, an untraced or a write run.
    for m in (_m({}), _m(ROWS, trace=False), _m(ROWS, op="write")):
        assert read(m) is None


def test_span_entries_follow_the_contract():
    bench = harness.load_benchmark()
    layers = {m["layer"] for m in bench["per_layer"]}
    for e in span_report.SPAN_METRICS:
        assert set(e) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert callable(harness.reader(e["name"]))
        assert e["source"] == "program_span"
        assert e["layer"] in layers | {"huffman decode"}


@pytest.mark.parametrize("cell", ["hurricane.read_once", "hurricane.reread"])
def test_span_report_on_the_cpu(cell):
    stock = tracing.reduce
    r = span_report.report(cell, 2**31 + 11, 0.2, device="cpu",
                           shape=(4, 20, 30))
    assert r["correct"] and r["reads"] >= 1
    names = set(r["spans_per_read"])
    assert {"repro_torch.session.decompress", "repro_torch.decode",
            "repro_torch.decode.phase4", "repro_torch.dequantize"} <= names
    assert ("repro_torch.plan" in names) == (cell == "hurricane.read_once")
    # No transfer on the CPU; nothing on a device, so all idle.
    assert r["metrics"]["host_syncs_per_read"] == 0.0
    assert r["metrics"]["h2d_uploads_per_read"] == 0.0
    assert r["busy_s"] == 0.0 and r["idle_under_program_share"] > 0.5
    assert tracing.reduce is stock          # the benchmark's own, restored
