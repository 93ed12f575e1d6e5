"""Serving scheduler: continuous batching of decode streams.

Port of ``src/repro/serving``.  The paper keeps one decode saturated; this
package keeps the *decoder* saturated across many concurrent sessions --
batched page-in dispatches, stage/decode double buffering (threads, and on
the card CUDA streams), prefix-aware block sharing, and a bounded
decoded-block pool.
"""

from repro_torch.serving.loadgen import Corpus, build_corpus, run_load
from repro_torch.serving.prefix_cache import BlockCache
from repro_torch.serving.scheduler import DecodeScheduler
from repro_torch.serving.sessions import Session, percentile, summarize_ttft

__all__ = [
    "BlockCache",
    "Corpus",
    "DecodeScheduler",
    "Session",
    "build_corpus",
    "percentile",
    "run_load",
    "summarize_ttft",
]
