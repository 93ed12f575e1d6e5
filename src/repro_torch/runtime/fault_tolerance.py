"""Fault tolerance: heartbeats, straggler mitigation, elastic re-mesh.

Port of ``src/repro/runtime/fault_tolerance.py``, the whole module: it is
plain Python, so the port keeps a copy with the same names, checks and
messages.  Multi-host failure handling is expressed as mechanism plus
simulation hooks:

  * HeartbeatMonitor -- wall-clock heartbeats per worker; a worker silent for
    ``timeout`` is declared dead.  On a real cluster the transport is the
    coordination service (``torch.distributed``'s store); here the clock is
    injectable.
  * StragglerMitigator -- per-step duration tracking; workers slower than
    ``factor`` x median over a window are flagged.  With a counter-based
    data pipeline a flagged worker's shard is reassigned by *renumbering
    shards*, no data motion needed.
  * plan_elastic_remesh -- on node loss, shrink the "data" axis to the
    largest feasible size, the model axis fixed.
  * RecoveryPolicy / with_retries -- what a consumer does when a read fails:
    transient IO errors are retried with exponential backoff, persistent
    corruption is raised / skipped / zero-filled per ``on_error``.  The store
    reader and the KV pager resolve their policy from the codec config
    (``CodecConfig.recovery`` / ``io_retries`` / ``io_backoff``) with
    per-call overrides.
"""

from __future__ import annotations

import dataclasses
import time

VALID_RECOVERY = ("raise", "skip", "zero_fill")


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What a store/checkpoint/paging consumer does when a read fails.

    ``on_error`` applies to *persistent* failures (corruption, truncation,
    decode-guard trips): ``"raise"`` propagates the named error, ``"skip"``
    omits the failed entry (callers report it as quarantined), and
    ``"zero_fill"`` substitutes zeros of the recorded shape/dtype.

    ``retries``/``backoff``/``multiplier`` apply to *transient* IO errors
    (``OSError``): the read is retried with exponential backoff before the
    failure is treated as persistent.
    """

    on_error: str = "raise"
    retries: int = 0
    backoff: float = 0.05
    multiplier: float = 2.0

    def __post_init__(self):
        if self.on_error not in VALID_RECOVERY:
            raise ValueError(
                f"on_error must be one of {VALID_RECOVERY}, "
                f"got {self.on_error!r}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.backoff < 0:
            raise ValueError(f"backoff must be >= 0, got {self.backoff}")

    @classmethod
    def resolve(cls, policy, config=None):
        """Normalise ``policy`` (None | str | RecoveryPolicy) to an instance.

        ``None`` inherits from ``config`` (a ``CodecConfig``-like object with
        ``recovery``/``io_retries``/``io_backoff``) when given, else the
        defaults.  A bare string sets ``on_error`` and keeps the config's
        retry settings.
        """
        if isinstance(policy, cls):
            return policy
        kw = {}
        if config is not None:
            kw = dict(on_error=getattr(config, "recovery", "raise"),
                      retries=getattr(config, "io_retries", 0),
                      backoff=getattr(config, "io_backoff", 0.05))
        if policy is not None:
            kw["on_error"] = policy
        return cls(**kw)


def with_retries(fn, policy: RecoveryPolicy | None = None, *,
                 retry_on=(OSError,), sleep=time.sleep, on_retry=None):
    """Call ``fn()``; retry transient failures per ``policy``.

    Only exceptions in ``retry_on`` are retried -- deterministic corruption
    (``StoreCorruptError`` etc.) re-raises immediately since re-reading the
    same bad bytes cannot help.  ``on_retry(attempt, exc)`` is invoked before
    each sleep (used for degradation counters).  The final failure is
    re-raised unchanged.
    """
    policy = policy or RecoveryPolicy()
    delay = policy.backoff
    for attempt in range(policy.retries + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt >= policy.retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                sleep(delay)
            delay *= policy.multiplier


@dataclasses.dataclass
class WorkerState:
    last_beat: float
    step_times: list


class HeartbeatMonitor:
    def __init__(self, workers, timeout: float = 60.0, clock=time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.workers = {w: WorkerState(clock(), []) for w in workers}

    def beat(self, worker, step_time: float | None = None):
        st = self.workers[worker]
        st.last_beat = self.clock()
        if step_time is not None:
            st.step_times.append(step_time)
            del st.step_times[:-32]

    def dead(self):
        now = self.clock()
        return [w for w, st in self.workers.items()
                if now - st.last_beat > self.timeout]


class StragglerMitigator:
    def __init__(self, factor: float = 2.0, window: int = 8):
        self.factor = factor
        self.window = window

    def stragglers(self, monitor: HeartbeatMonitor):
        med = self._median([
            st.step_times[-1] for st in monitor.workers.values()
            if st.step_times])
        if med is None:
            return []
        out = []
        for w, st in monitor.workers.items():
            recent = st.step_times[-self.window:]
            if len(recent) >= self.window // 2 and \
                    self._median(recent) > self.factor * med:
                out.append(w)
        return out

    @staticmethod
    def _median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None


def plan_elastic_remesh(n_alive: int, model_parallel: int = 16):
    """Largest (data, model) mesh fitting ``n_alive`` chips, model fixed.

    Returns (data, model) or None if even one model group does not fit.
    Growing back after repair is the same operation in reverse; since the
    data pipeline is counter-based, shard renumbering is free.
    """
    data = n_alive // model_parallel
    if data < 1:
        return None
    # prefer powers of two for collective efficiency
    p = 1
    while p * 2 <= data:
        p *= 2
    return (p, model_parallel)


def reassign_shards(n_shards: int, dead: list[int]) -> dict[int, int]:
    """Deterministic shard reassignment: dead worker w's shard moves to
    alive worker (w + k) % n; with counter-based data, the assignee simply
    starts calling ``batch_at`` with the extra shard id."""
    alive = [w for w in range(n_shards) if w not in dead]
    mapping = {}
    for i, w in enumerate(dead):
        mapping[w] = alive[i % len(alive)]
    return mapping
