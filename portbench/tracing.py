"""The device trace of a window, reduced to what the metrics read.

``torch.profiler`` (CUPTI) records every kernel, copy and set on the card
and the host's operations.  :func:`reduce` merges the device intervals
into busy time, sums device time by operation name, and names each idle
gap of the device by the innermost host operation that was running at its
middle (the benchmark's own spans included), so ``idle_gaps`` says what
the host was doing while the card waited.
"""

from __future__ import annotations

import bisect
import collections

import torch
from torch.autograd import DeviceType

TOP = 10
#: Characters kept of an operation's name (kernel names carry templates).
NAME_CHARS = 160
#: Host-side span names the harness opens around each call.
SPAN_PREFIX = "portbench."


def profiler():
    """A profiler of the host and the card, without shapes or stacks."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _merge(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def reduce(events, window_us: "tuple[float, float]") -> dict:
    """``busy_s``, ``device_ops`` and ``idle_gaps`` of the window
    ``(start, end)`` in the trace's microseconds."""
    w0, w1 = window_us
    device, host = [], []
    by_name = collections.Counter()
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if hi <= w0 or lo >= w1:
            continue
        lo, hi = max(lo, w0), min(hi, w1)
        if e.device_type == DeviceType.CUDA:
            # A host span is mirrored on the device's timeline as an
            # annotation: it is no work of the card.
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(SPAN_PREFIX):
                continue
            device.append((lo, hi))
            by_name[e.name[:NAME_CHARS]] += (hi - lo) * 1e-6
        elif e.device_type == DeviceType.CPU:
            host.append((lo, hi, e.name))
    busy = _merge(device)
    busy_s = sum(hi - lo for lo, hi in busy) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        name = "host: no operation"
        # The innermost host operation open at the gap's middle: the one
        # that started last among those still running.
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
            if mid - host[j][0] > 5e6:       # nothing open that long ago
                break
        gaps[name] += (hi - lo) * 1e-6
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}
