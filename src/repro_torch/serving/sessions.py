"""Serving sessions and their latency accounting.

Port of ``src/repro/serving/sessions.py`` (plain Python).

A ``Session`` is one decode stream: it arrives (Poisson in the load
generator), needs a set of KV blocks paged in before its first token can be
computed (some shared with other sessions -- the hot prefix -- some unique),
and reports **time-to-first-token** (TTFT): arrival -> every needed block
resolved.  The scheduler never sees sessions directly, only (session id,
block id) requests; this module is the bookkeeping around them.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Session:
    """One decode stream's lifecycle, timed against a shared clock."""

    sid: int
    block_ids: list                  # blocks needed before the first token
    arrival_s: float = 0.0           # offset from the run's t0
    t_first_token: "float | None" = None   # offset; None until served
    error: "Exception | None" = None

    @property
    def done(self) -> bool:
        return self.t_first_token is not None or self.error is not None

    @property
    def ttft_s(self) -> "float | None":
        """Arrival -> first token, seconds (None until served)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_s

    def mark_served(self, t0: float):
        self.t_first_token = time.perf_counter() - t0


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]) of a non-empty sequence."""
    xs = sorted(xs)
    if not xs:
        raise ValueError("percentile of empty sequence")
    rank = max(0, min(len(xs) - 1, round(p / 100.0 * (len(xs) - 1))))
    return float(xs[rank])


def summarize_ttft(sessions) -> dict:
    """p50/p99/mean TTFT (ms) over the served sessions + failure count."""
    served = [s.ttft_s for s in sessions if s.ttft_s is not None]
    failed = sum(1 for s in sessions if s.error is not None)
    if not served:
        return {"n": 0, "failed": failed, "p50_ms": float("nan"),
                "p99_ms": float("nan"), "mean_ms": float("nan")}
    return {
        "n": len(served),
        "failed": failed,
        "p50_ms": percentile(served, 50) * 1e3,
        "p99_ms": percentile(served, 99) * 1e3,
        "mean_ms": sum(served) / len(served) * 1e3,
    }
