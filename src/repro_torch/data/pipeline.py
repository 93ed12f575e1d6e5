"""Deterministic, sharded, skip-ahead synthetic LM data, and synthetic
scientific fields.

Port of ``src/repro/data/pipeline.py``.  ``smooth_field`` is numpy, so the
same seed gives the reference's field.  ``SyntheticLM`` keeps the
reference's contract: a batch is a pure function of ``(seed, shard_id,
step)``, so a restart resumes exactly where it died and any host can
rebuild any other host's batch; tokens follow Zipf(1.1) marginals (or are
uniform); ``labels`` are the tokens shifted left with -1 in the last
place.  The values are the port's own, not the reference's: the reference
draws with ``jax.random.categorical`` over threefry, which the port does
not have.  Here each batch is drawn by inverse-CDF sampling
(``torch.searchsorted`` over the cumulative table) from float64 uniforms of
a CPU ``torch.Generator`` seeded from ``(seed, shard_id, step)`` by a fixed
mixing, then moved to the device asked for, so a batch is the same on the
CPU and on the card.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0
    mode: str = "zipf"        # "zipf" (realistic marginals) | "uniform"

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


def _mix(*words: int) -> int:
    """A 63-bit generator seed from integers: splitmix64's finalizer over
    each word folded into the state."""
    z = 0x9E3779B97F4A7C15
    for w in words:
        z = (z ^ (int(w) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        z = (z ^ (z >> 31)) * 0x94D049BB133111EB & _MASK64
        z ^= z >> 29
    return z >> 1


class SyntheticLM:
    """Deterministic synthetic next-token data on ``device`` (the card by
    default)."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} was asked for, but "
                f"torch.cuda.is_available() is False.  Pass device='cpu' "
                f"to run on the CPU.")
        if cfg.mode == "zipf":
            ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
            p = 1.0 / ranks ** 1.1
        elif cfg.mode == "uniform":
            p = np.ones(cfg.vocab, np.float64)
        else:
            raise ValueError(f"mode must be 'zipf' or 'uniform', got "
                             f"{cfg.mode!r}")
        cdf = np.cumsum(p / p.sum())
        self._cdf = torch.from_numpy(cdf)

    def batch_at(self, step: int) -> dict:
        """``{"tokens", "labels"}``, int32 (shard_batch, seq_len)."""
        cfg = self.cfg
        gen = torch.Generator(device="cpu")
        gen.manual_seed(_mix(cfg.seed, cfg.shard_id, step))
        u = torch.rand((cfg.shard_batch, cfg.seq_len), generator=gen,
                       dtype=torch.float64)
        tokens = torch.searchsorted(self._cdf, u, right=True).clamp_(
            max=cfg.vocab - 1).to(torch.int32)
        labels = torch.cat([tokens[:, 1:], torch.full(
            (cfg.shard_batch, 1), -1, dtype=torch.int32)], dim=1)
        return {"tokens": tokens.to(self.device),
                "labels": labels.to(self.device)}

    def prefetch(self, start_step: int, depth: int = 2):
        """Background-thread prefetch iterator (host-side double buffering)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch_at(step)))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def smooth_field(shape, seed: int = 0, dtype=np.float32):
    """Synthetic 'scientific' field: integrated noise -> Lorenzo-predictable."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float64)
    for ax in range(len(shape)):
        x = np.cumsum(x, axis=ax)
    x /= np.abs(x).max() + 1e-9
    return x.astype(dtype)
