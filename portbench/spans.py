"""The program's spans in a device trace, reduced per span name.

``repro_torch`` opens profiler spans (``repro_torch.core.trace``) at each
layer of a read.  They are host events on the profiler's clock, the clock
of the card's kernels and copies in the same trace, so each idle gap of the
device and each kernel can be put down to a span.  :func:`reduce` gives,
for every span name that starts with ``prefix``:

* ``n``: spans in the window;
* ``host_s``: their summed durations;
* ``self_s``: ``host_s`` less the durations of the spans nested directly
  inside them;
* ``device_s``: the device's busy time, overlaps merged, of the kernels and
  copies launched inside them, at any depth.  A device event is launched
  where its runtime call ran: the host event of the same correlation id
  named for the CUDA runtime or driver (``cudaLaunchKernel``,
  ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...);
* ``idle_s``: the device's idle time during which the span was the
  innermost span of ``prefix`` open.

The device's busy time follows the rule of ``tracing.reduce``: a span
mirrored on the device's timeline is no work of the card.
"""

from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType

PREFIX = "repro_torch."
#: Span names of the program and of the harness: never device work.
ANNOTATIONS = (PREFIX, "portbench.")
#: Host events of the CUDA runtime and driver API: ``cuda...``, ``cu...``.
RUNTIME = "cu"


def _merge(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _segments(spans):
    """Nest ``spans`` (``(lo, hi, name)``, sorted by start, outer first)
    with a stack.  Returns each span's parent index (or -1) and the
    segments ``(lo, hi, index)`` of the timeline in which span ``index``
    is the innermost one open."""
    parent = [-1] * len(spans)
    segs, stack, cursor = [], [], None

    def close_until(t):
        nonlocal cursor
        while stack and spans[stack[-1]][1] <= t:
            top = stack.pop()
            segs.append((cursor, spans[top][1], top))
            cursor = spans[top][1]

    for i, (lo, hi, _) in enumerate(spans):
        close_until(lo)
        if stack:
            segs.append((cursor, lo, stack[-1]))
            parent[i] = stack[-1]
        cursor = lo
        stack.append(i)
    close_until(float("inf"))
    return parent, [s for s in segs if s[1] > s[0]]


def reduce(events, window_us: "tuple[float, float]",
           prefix: str = PREFIX) -> dict:
    """``{name: {"n", "host_s", "self_s", "device_s", "idle_s"}}`` of the
    spans named ``prefix...`` in the window ``(start, end)``, in the
    trace's microseconds."""
    w0, w1 = window_us
    spans, device, launch = [], [], {}
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU and e.name.startswith(RUNTIME):
            launch[e.id] = lo
        if hi <= w0 or lo >= w1:
            continue
        lo, hi = max(lo, w0), min(hi, w1)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(ANNOTATIONS):
                continue
            device.append((lo, hi, e))
        elif e.device_type == DeviceType.CPU and e.name.startswith(prefix):
            spans.append((lo, hi, e.name))
    spans.sort(key=lambda s: (s[0], -s[1]))
    parent, segs = _segments(spans)
    seg_starts = [s[0] for s in segs]

    out = collections.defaultdict(lambda: {"n": 0, "host_s": 0.0,
                                           "self_s": 0.0, "device_s": 0.0,
                                           "idle_s": 0.0})
    child_s = [0.0] * len(spans)
    for i, (lo, hi, _) in enumerate(spans):
        if parent[i] >= 0:
            child_s[parent[i]] += hi - lo
    for i, (lo, hi, name) in enumerate(spans):
        r = out[name]
        r["n"] += 1
        r["host_s"] += (hi - lo) * 1e-6
        r["self_s"] += (hi - lo - child_s[i]) * 1e-6

    def innermost(t):
        j = bisect.bisect_right(seg_starts, t) - 1
        return segs[j][2] if j >= 0 and segs[j][1] > t else -1

    # Device time by the spans open at each event's launch.
    by_name = collections.defaultdict(list)
    for lo, hi, e in device:
        t = launch.get(e.id)
        i = -1 if t is None else innermost(t)
        names = set()
        while i >= 0:
            names.add(spans[i][2])
            i = parent[i]
        for name in names:
            by_name[name].append((lo, hi))
    for name, intervals in by_name.items():
        out[name]["device_s"] = sum(
            hi - lo for lo, hi in _merge(intervals)) * 1e-6

    # Idle time by the innermost span open.
    busy = _merge((lo, hi) for lo, hi, _ in device)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    j = 0
    for lo, hi in zip(edges[0::2], edges[1::2]):
        while j < len(segs) and segs[j][1] <= lo:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < hi:
            s_lo, s_hi, i = segs[k]
            overlap = min(hi, s_hi) - max(lo, s_lo)
            if overlap > 0:
                out[spans[i][2]]["idle_s"] += overlap * 1e-6
            k += 1
    return dict(out)
