"""Spans on the profiler's clock, free while no profiler records.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
records (``torch.profiler.profile``, the benchmark's ``--trace 1``) and one
shared null context otherwise: the off path is a single check of the
profiler's state.  The spans are profiler events, so they share the
timeline of the device's kernels and copies in the same trace, and stay in
the profiler's memory until it writes its trace.

``crossing(name, device)`` is the span of a copy between the host and
``device``: it opens only where ``device`` is not the host, so a run on the
CPU records none.  A name ends ``.sync`` where the host waits for the
device (a device-to-host read) and ``.h2d`` for a host-to-device upload.
Every name starts with ``repro_torch.``.
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str, args: "str | None" = None):
    """A profiler span named ``name`` (with ``args``) while a profiler
    records; the shared null context otherwise."""
    if not _recording():
        return _NULL
    return torch.profiler.record_function(name, args)


def crossing(name: str, device):
    """``span(name)`` for a copy between the host and ``device`` (a
    ``torch.device``, or None for host data); none on the host."""
    if device is None or device.type == "cpu" or not _recording():
        return _NULL
    return torch.profiler.record_function(name)
