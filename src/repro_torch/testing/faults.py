"""Deterministic fault-injection campaigns over every decode consumer.

Port of ``src/repro/testing/faults.py``: the same channels, the same
seeded schedule and the same classification.  The robustness layer's
invariant is falsifiable: **every injected corruption is either detected or
safely contained -- never silent wrong data, never a hang, never an
unnamed crash.**  This module injects seeded faults -- bit-flips in archive
bytes and in-memory ``Compressed`` fields, truncations, torn manifests,
missing files, transient IO errors -- into the four consumers (direct
decode, store archives, checkpoint restore, KV paging) and classifies each
outcome:

  detected    a named error (``StoreError`` family incl. ``PageLostError``
              and ``StoreIOError``, ``CheckpointIntegrityError``,
              ``DecodeGuardError``) reached the caller
  bit_exact   the fault landed in dead bytes (alignment padding, unused
              header fields); output is bit-identical to the baseline
  recovered   a non-raise recovery policy salvaged the read: intact
              entries bit-exact, failed ones quarantined / zero-filled /
              retried -- and the degradation was *reported* (quarantine
              dict, ``pages_lost`` / ``io_retries`` counters)
  contained   an un-checksummed in-memory corruption decoded to garbage,
              but bounded: right shape/dtype, terminated, no crash

  silent      VIOLATION -- wrong data with no error and no report
  unnamed     VIOLATION -- an exception outside the named families
  hang        VIOLATION -- the case exceeded its watchdog timeout

On ``backend="cuda"`` the decode channel hands corrupt streams, gap
arrays, outlier lists and decode tables to the kernels, on the card.  An
out-of-bounds access there would poison the CUDA context, and every later
case would end "unnamed": the campaign is also the kernels' guard test.

The port's ``KVPager`` offloads and pages in *in place*, where the
reference returns copies, so the corpus snapshots the KV cache with a
copy before it offloads, and each paging case starts from a fresh copy of
the post-offload cache.

``run_campaign(seed=..., cases=...)`` is pure-deterministic per seed (the
case schedule round-robins over the fault channels);
``tools/faultinject_torch.py`` is its CLI.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointIntegrityError, \
    CheckpointManager
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.store import Archive, ArchiveWriter, KVPager, PageLostError
from repro_torch.store import format as F

#: Exception families a consumer may legitimately raise on corrupt input.
#: Anything else escaping a consumer is an "unnamed" invariant violation.
NAMED_ERRORS = (F.StoreError, CheckpointIntegrityError, hp.DecodeGuardError)

VIOLATIONS = ("silent", "unnamed", "hang")


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def flip_bit(path: str, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit of a file in place."""
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        b = f.read(1)
        f.seek(byte_offset)
        f.write(bytes([b[0] ^ (1 << bit)]))


def truncate_file(path: str, size: int) -> None:
    with open(path, "r+b") as f:
        f.truncate(size)


def flip_array_bit(arr: np.ndarray, rng) -> np.ndarray:
    """Copy ``arr`` with one random bit flipped in its raw bytes."""
    raw = bytearray(np.ascontiguousarray(arr).tobytes())
    if not raw:
        return np.array(arr)
    i = int(rng.randint(len(raw)))
    raw[i] ^= 1 << int(rng.randint(8))
    return np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(arr.shape)


def _flip_tensor_bit(t: torch.Tensor, rng) -> torch.Tensor:
    """``flip_array_bit`` of a tensor's host bytes, back on its device."""
    flipped = flip_array_bit(t.cpu().numpy(), rng)
    return torch.from_numpy(flipped.copy()).to(t.device)


def _host(a) -> np.ndarray:
    """A tensor's raw bytes as a numpy array (bfloat16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# Case / report records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultCase:
    consumer: str            # "store" | "decode" | "checkpoint" | "paging"
    kind: str                # e.g. "flip", "truncate", "torn_manifest"
    seed: int
    detail: str = ""


@dataclasses.dataclass
class CaseResult:
    case: FaultCase
    outcome: str             # see module docstring
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.outcome not in VIOLATIONS


@dataclasses.dataclass
class CampaignReport:
    results: list

    @property
    def violations(self) -> list:
        return [r for r in self.results if not r.ok]

    @property
    def ok(self) -> bool:
        return not self.violations

    def counts(self) -> dict:
        out: dict = {}
        for r in self.results:
            key = (r.case.consumer, r.outcome)
            out[key] = out.get(key, 0) + 1
        return out

    def summary(self) -> str:
        consumers = sorted({r.case.consumer for r in self.results})
        outcomes = ["detected", "bit_exact", "recovered", "contained",
                    "silent", "unnamed", "hang"]
        counts = self.counts()
        width = max(len(c) for c in consumers + ["consumer"]) + 2
        lines = ["consumer".ljust(width)
                 + "".join(o.rjust(11) for o in outcomes)]
        for c in consumers:
            lines.append(c.ljust(width) + "".join(
                str(counts.get((c, o), 0)).rjust(11) for o in outcomes))
        lines.append(f"total {len(self.results)} cases, "
                     f"{len(self.violations)} violations")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Corpus: one small world every case perturbs a copy of
# ---------------------------------------------------------------------------


def _smooth(rng, n: int) -> np.ndarray:
    return np.cumsum(rng.randn(n).astype(np.float32) * 0.02) \
        .astype(np.float32)


@dataclasses.dataclass
class Corpus:
    dir: str
    codec: Codec
    arrays: dict             # name -> np.float32 baseline
    archive: str             # pristine .szt path
    baseline: dict           # name -> decoded np baseline (bit-level truth)
    ckpt_dir: str            # pristine checkpoint dir (2 steps)
    ckpt_baseline: dict      # fname -> np array from a clean restore
    kv_dir: str              # pager directory
    kv_meta: dict            # block meta of the offloaded block
    kv_block_id: int
    kv_block_bytes: bytes    # pristine block archive bytes
    kv_cache: dict           # post-offload cache template (span zeroed)
    kv_snapshot: dict        # name -> pre-offload np.float32 values


def build_corpus(base_dir: str, backend: str = "ref",
                 seed: int = 1234) -> Corpus:
    """Build the pristine world: archive + checkpoint + offloaded KV block.

    Small on purpose (200 cases run against it); every decode shape
    repeats across cases so plans and LUTs are reused.
    """
    rng = np.random.RandomState(seed)
    codec = Codec(CodecConfig(backend=backend), plan_cache=PlanCache())
    os.makedirs(base_dir, exist_ok=True)

    # -- store archive ------------------------------------------------------
    arrays = {f"t{i}": _smooth(rng, n)
              for i, n in enumerate((4096, 4096, 2048))}
    archive = os.path.join(base_dir, "corpus.szt")
    with ArchiveWriter(archive, codec=codec) as w:
        for name, arr in arrays.items():
            w.add_array(name, arr)
    with Archive(archive, codec=codec) as ar:
        baseline = {k: _host(v)
                    for k, v in ar.read_all(group_chunks=2).items()}

    # -- checkpoint (2 steps so a torn newest manifest can fall back) -------
    ckpt_dir = os.path.join(base_dir, "ckpt")
    mgr = CheckpointManager(ckpt_dir, codec=codec, compress_min_size=1024)
    params = {"w1": rng.randn(48, 48).astype(np.float32),
              "w2": rng.randn(40, 40).astype(np.float32),
              "count": np.int32(3)}
    mgr.save(1, params)
    mgr.save(2, params)
    r = mgr.restore(2)
    ckpt_baseline = {f"params.{k}": _host(v)
                     for k, v in r["params"].items()}

    # -- one offloaded KV block ---------------------------------------------
    kv_dir = os.path.join(base_dir, "kv")
    pager = KVPager(kv_dir, codec=codec, seq_axis=2)
    cache = {"k": torch.from_numpy(rng.randn(1, 1, 16, 8).astype(
                 np.float32)).to(codec.device),
             "v": torch.from_numpy(rng.randn(1, 1, 16, 8).astype(
                 np.float32)).to(codec.device)}
    # A copy: the pager zeroes the offloaded span of these tensors in place.
    kv_snapshot = {k: _host(v).copy() for k, v in cache.items()}
    cache, block_id = pager.offload(cache, 0, 8, keys=["k", "v"])
    meta = pager.block_meta(block_id)
    with open(meta["path"], "rb") as f:
        kv_block_bytes = f.read()

    return Corpus(dir=base_dir, codec=codec, arrays=arrays, archive=archive,
                  baseline=baseline, ckpt_dir=ckpt_dir,
                  ckpt_baseline=ckpt_baseline, kv_dir=kv_dir,
                  kv_meta=meta, kv_block_id=block_id,
                  kv_block_bytes=kv_block_bytes, kv_cache=dict(cache),
                  kv_snapshot=kv_snapshot)


def _fresh_cache(corpus: Corpus) -> dict:
    """A copy of the post-offload cache: ``page_in`` writes into the
    tensors it is given, which must not be the corpus's."""
    return {k: v.clone() for k, v in corpus.kv_cache.items()}


# ---------------------------------------------------------------------------
# Fault channels (one function per channel; all deterministic per rng)
# ---------------------------------------------------------------------------


def _bit_exact(a, b) -> bool:
    a, b = _host(a), _host(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _work_archive(corpus: Corpus, mutate) -> str:
    work = os.path.join(corpus.dir, "work.szt")
    shutil.copyfile(corpus.archive, work)
    mutate(work)
    return work


def _read_and_classify(corpus: Corpus, work: str) -> tuple:
    """Open + fully decode a (possibly corrupt) archive under "raise"."""
    with Archive(work, codec=corpus.codec) as ar:
        outs = ar.read_all(group_chunks=2, policy="raise")
    for name, arr in outs.items():
        if not _bit_exact(arr, corpus.baseline[name]):
            return ("silent", f"{name} decoded to different bytes "
                              f"with no error")
    if set(outs) != set(corpus.baseline):
        return ("silent", "chunks vanished without an error")
    return ("bit_exact", "")


def case_store_flip(corpus: Corpus, rng) -> tuple:
    size = os.path.getsize(corpus.archive)
    off, bit = int(rng.randint(size)), int(rng.randint(8))
    work = _work_archive(corpus, lambda p: flip_bit(p, off, bit))
    return _read_and_classify(corpus, work)


def case_store_truncate(corpus: Corpus, rng) -> tuple:
    size = os.path.getsize(corpus.archive)
    cut = int(rng.randint(size))          # [0, size): always drops bytes
    work = _work_archive(corpus, lambda p: truncate_file(p, cut))
    return _read_and_classify(corpus, work)


def case_store_policy(corpus: Corpus, rng) -> tuple:
    """Corrupt one chunk's payload; skip/zero_fill must salvage the rest."""
    name = list(corpus.arrays)[int(rng.randint(len(corpus.arrays)))]
    with Archive(corpus.archive, codec=corpus.codec) as ar:
        rec = ar.chunk(name)
        off = rec.units.offset + int(rng.randint(max(rec.units.length, 1)))
    work = _work_archive(
        corpus, lambda p: flip_bit(p, off, int(rng.randint(8))))
    policy = ("skip", "zero_fill")[int(rng.randint(2))]
    failures: list = []
    with Archive(work, codec=corpus.codec) as ar:
        outs = ar.read_all(group_chunks=2, policy=policy,
                           on_error=lambda n, e: failures.append((n, e)))
        stats = dict(ar.stats)
    if not failures:
        # units bytes are fully CRC-covered, so a flip inside the blob
        # extent must fail -- reaching here without a failure means the
        # decode silently absorbed corruption.
        if all(k in outs and _bit_exact(outs[k], corpus.baseline[k])
               for k in corpus.baseline):
            return ("bit_exact", "flip landed in dead bytes")
        return ("silent", "corruption absorbed without a failure report")
    if not all(isinstance(e, NAMED_ERRORS) for _, e in failures):
        return ("unnamed", f"on_error saw {failures}")
    for k, arr in outs.items():
        if k == name and policy == "zero_fill":
            if np.any(_host(arr)):
                return ("silent", f"zero_fill of {k} is not zero")
        elif not _bit_exact(arr, corpus.baseline[k]):
            return ("silent", f"intact chunk {k} changed under {policy}")
    degraded = stats["chunks_skipped"] + stats["chunks_zero_filled"]
    if policy == "skip" and name not in outs and degraded:
        return ("recovered", f"{name} skipped, rest intact")
    if policy == "zero_fill" and name in outs and degraded:
        return ("recovered", f"{name} zero-filled, rest intact")
    return ("silent", "degradation was not reported")


def case_decode_field_flip(corpus: Corpus, rng) -> tuple:
    """Flip a bit in an in-memory ``Compressed`` field; no checksum guards
    this channel, so garbage output is acceptable -- crash/hang is not."""
    name = list(corpus.arrays)[int(rng.randint(len(corpus.arrays)))]
    codec = Codec(corpus.codec.config, plan_cache=PlanCache())
    c = codec.compress(corpus.arrays[name])
    field = ("units", "gaps", "outlier_pos", "outlier_val",
             "total_bits", "dec_len", "enc_len")[int(rng.randint(7))]
    stream = c.stream
    book = c.codebook
    if field in ("units", "gaps"):
        flipped = _flip_tensor_bit(getattr(stream, field), rng)
        stream = dataclasses.replace(stream, **{field: flipped})
    elif field == "total_bits":
        delta = int(rng.randint(1, 1 << 20))
        stream = dataclasses.replace(
            stream, total_bits=int(stream.total_bits) + delta)
    elif field in ("outlier_pos", "outlier_val"):
        flipped = _flip_tensor_bit(getattr(c, field), rng)
        c = dataclasses.replace(c, **{field: flipped})
    else:                                 # dec_len / enc_len table entry
        tab = np.array(getattr(book, field))
        if tab.size:
            tab[int(rng.randint(tab.size))] = 200   # >> max_len
        book = dataclasses.replace(book, **{field: tab})
    c = dataclasses.replace(c, stream=stream, codebook=book)
    c.__dict__.pop("_digest", None)       # never reuse the pristine plan

    out = codec.decompress(c)
    out_np = _host(out)                   # forces device completion
    if out_np.shape != tuple(c.shape):
        return ("silent", f"shape {out_np.shape} != {tuple(c.shape)}")
    if not np.isfinite(out_np).all():
        # quantized reconstruction is bounded by construction; NaN/inf can
        # only come from reading memory it shouldn't
        return ("silent", "non-finite values decoded")
    if _bit_exact(out_np, corpus.baseline[name]):
        return ("bit_exact", f"{field} flip was inert")
    return ("contained", f"{field} corrupt -> bounded garbage")


_CKPT_POLICIES = ("raise", "skip", "zero_fill")


def case_checkpoint(corpus: Corpus, rng) -> tuple:
    """Corrupt a copied checkpoint dir; restore under a cycling policy."""
    work = os.path.join(corpus.dir, "ckpt_work")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(corpus.ckpt_dir, work)
    step2 = os.path.join(work, "step_00000002")
    targets = [os.path.join(step2, "archive.szt"),
               os.path.join(step2, "manifest.json"),
               os.path.join(step2, "params.count.npy")]
    kind = int(rng.randint(4))
    if kind < 2:                          # flip a byte somewhere
        path = targets[int(rng.randint(len(targets)))]
        flip_bit(path, int(rng.randint(os.path.getsize(path))),
                 int(rng.randint(8)))
    elif kind == 2:                       # torn file (truncation)
        path = targets[int(rng.randint(len(targets)))]
        truncate_file(path, int(rng.randint(os.path.getsize(path))))
    else:                                 # missing file
        os.unlink(targets[int(rng.randint(len(targets)))])

    policy = _CKPT_POLICIES[int(rng.randint(3))]
    mgr = CheckpointManager(work, codec=corpus.codec,
                            compress_min_size=1024)
    try:
        r = mgr.restore(policy=policy)
    except NAMED_ERRORS + (CheckpointIntegrityError,) as e:
        if policy == "raise":
            return ("detected", type(e).__name__)
        return ("unnamed", f"{policy} still raised {type(e).__name__}: {e}")
    if r is None:
        return ("recovered", "no intact step (all quarantined)")
    quarantined = set(r.get("quarantined", ()))
    fallback = r.get("fallback_from", [])
    flat = {f"params.{k}": v for k, v in r["params"].items()}
    for fname, want in corpus.ckpt_baseline.items():
        got = flat.get(fname)
        if got is None:
            # A manifest bit-flip can mangle the *name* an entry is
            # reported under; any non-empty quarantine/fallback report
            # still satisfies "never silent".
            if policy != "raise" and (quarantined or fallback):
                continue
            return ("silent", f"{fname} vanished unreported")
        if fname in quarantined:
            if policy == "zero_fill" and np.any(_host(got)):
                return ("silent", f"zero_fill of {fname} is not zero")
            continue
        if not _bit_exact(got, want):
            return ("silent", f"{fname} changed, not quarantined")
    if quarantined or fallback:
        return ("recovered", f"quarantined={sorted(quarantined)} "
                             f"fallback={len(fallback)}")
    return ("bit_exact", "fault landed in dead bytes")


def case_checkpoint_torn_save(corpus: Corpus, rng) -> tuple:
    """Simulate a crash mid-save: a stray .tmp step dir + torn newest
    manifest.  Salvage must land on the newest intact step."""
    work = os.path.join(corpus.dir, "ckpt_work")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(corpus.ckpt_dir, work)
    # half-renamed save attempt
    shutil.copytree(os.path.join(work, "step_00000002"),
                    os.path.join(work, "step_00000003.tmp"))
    mpath = os.path.join(work, "step_00000002", "manifest.json")
    truncate_file(mpath, int(rng.randint(os.path.getsize(mpath))))
    mgr = CheckpointManager(work, codec=corpus.codec,
                            compress_min_size=1024)
    try:
        mgr.restore(policy="raise")
        # truncating strictly inside a json.dump output always breaks it;
        # a restore that succeeds is judged by the fallback check below.
    except CheckpointIntegrityError:
        pass
    except Exception as e:                # noqa: BLE001
        return ("unnamed", f"{type(e).__name__}: {e}")
    r = mgr.restore(policy="skip")
    if r is None or r["step"] != 1:
        return ("silent", f"fell back to {r and r['step']}, expected 1")
    flat = {f"params.{k}": v for k, v in r["params"].items()}
    for fname, want in corpus.ckpt_baseline.items():
        got = flat.get(fname)
        if got is None or not _bit_exact(got, want):
            return ("silent", f"{fname} wrong after fallback")
    if not r["fallback_from"]:
        return ("silent", "fallback not reported")
    return ("recovered", "fell back to step 1")


def case_paging(corpus: Corpus, rng) -> tuple:
    """Corrupt / remove the offloaded block; page_in must raise the named
    PageLostError (+ counter) or restore bit-exact values."""
    path = corpus.kv_meta["path"]
    with open(path, "wb") as f:
        f.write(corpus.kv_block_bytes)    # restore pristine block
    kind = int(rng.randint(3))
    if kind == 0:
        flip_bit(path, int(rng.randint(len(corpus.kv_block_bytes))),
                 int(rng.randint(8)))
    elif kind == 1:
        truncate_file(path, int(rng.randint(len(corpus.kv_block_bytes))))
    else:
        os.unlink(path)
    pager = KVPager(corpus.kv_dir, codec=corpus.codec, seq_axis=2)
    pager.adopt_block(corpus.kv_block_id, corpus.kv_meta)
    cache = _fresh_cache(corpus)
    try:
        cache = pager.page_in(cache, corpus.kv_block_id)
    except F.StoreError as e:
        if not isinstance(e, PageLostError):
            return ("unnamed", f"expected PageLostError, got "
                               f"{type(e).__name__}")
        if pager.stats["pages_lost"] != 1:
            return ("silent", "pages_lost counter not incremented")
        if corpus.kv_block_id in pager.resident_blocks:
            return ("silent", "lost block not evicted")
        return ("detected", "PageLostError + eviction + counter")
    lo, hi = corpus.kv_meta["lo"], corpus.kv_meta["hi"]
    for k in corpus.kv_meta["names"]:
        got = _host(cache[k][:, :, lo:hi].float())
        want = corpus.kv_snapshot[k][:, :, lo:hi]
        # paging is lossy by design: compare against a pristine page-in
        # is bit-exact only because the block bytes are identical
        if got.tobytes() != want.tobytes():
            # the baseline snapshot is pre-compression; recompute the
            # legitimate decode from pristine bytes instead
            with open(path, "wb") as f:
                f.write(corpus.kv_block_bytes)
            ref_pager = KVPager(corpus.kv_dir, codec=corpus.codec,
                                seq_axis=2)
            ref_pager.adopt_block(corpus.kv_block_id, corpus.kv_meta)
            ref = ref_pager.page_in(_fresh_cache(corpus),
                                    corpus.kv_block_id)
            if got.tobytes() != _host(ref[k][:, :, lo:hi].float()).tobytes():
                return ("silent", f"block {k} decoded differently "
                                  f"with no error")
    return ("bit_exact", "fault landed in dead bytes")


def inject_blob_failures(ar: Archive, n: int) -> dict:
    """Make the next ``n`` raw blob reads of ``ar`` raise ``OSError``
    (transient-IO simulation).  Returns the shared counter state.

    The patch is an instance attribute: the reader calls ``self._blob``,
    on its prefetch thread too (one thread reads at a time), so every read
    goes through it."""
    orig = ar._blob
    state = {"left": n, "injected": 0}

    def flaky(ref, dtype):
        if state["left"] > 0:
            state["left"] -= 1
            state["injected"] += 1
            raise OSError("injected transient IO failure")
        return orig(ref, dtype)

    ar._blob = flaky
    return state


def case_io_transient(corpus: Corpus, rng) -> tuple:
    """Transient OSErrors during chunk reads: few must be retried away
    (bit-exact + io_retries counted); a persistent failure must surface
    as the named StoreIOError."""
    persistent = bool(rng.randint(2))
    n = 1000 if persistent else 1 + int(rng.randint(2))
    with Archive(corpus.archive, codec=corpus.codec) as ar:
        state = inject_blob_failures(ar, n)
        try:
            outs = ar.read_all(group_chunks=2, policy="raise")
        except F.StoreIOError:
            if not persistent:
                return ("unnamed", "transient failure was not retried")
            return ("detected", "persistent IO -> StoreIOError")
        if persistent:
            return ("silent", "persistent IO error vanished")
        if ar.stats["io_retries"] < 1 or state["injected"] < n:
            return ("silent", "retry not recorded")
        for k, arr in outs.items():
            if not _bit_exact(arr, corpus.baseline[k]):
                return ("silent", f"{k} wrong after retry")
        return ("recovered", f"{state['injected']} transient errors "
                             f"retried away")


CHANNELS = (case_store_flip, case_store_truncate, case_store_policy,
            case_decode_field_flip, case_checkpoint,
            case_checkpoint_torn_save, case_paging, case_io_transient)

_CONSUMER = {case_store_flip: "store", case_store_truncate: "store",
             case_store_policy: "store",
             case_decode_field_flip: "decode",
             case_checkpoint: "checkpoint",
             case_checkpoint_torn_save: "checkpoint",
             case_paging: "paging", case_io_transient: "store"}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _run_with_watchdog(fn, timeout: float):
    """Run ``fn`` on a watchdog thread; a case that outlives ``timeout``
    is a hang (the daemon thread is abandoned -- acceptable for a test
    harness, fatal evidence for the decoder)."""
    box: dict = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:        # noqa: BLE001 -- classified below
            box["exc"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        return "hang", None
    if "exc" in box:
        return "exc", box["exc"]
    return "ok", box["value"]


def run_case(channel, corpus: Corpus, seed: int,
             timeout: float = 120.0) -> CaseResult:
    rng = np.random.RandomState(seed)
    case = FaultCase(consumer=_CONSUMER[channel],
                     kind=channel.__name__.split("case_", 1)[-1], seed=seed)
    status, value = _run_with_watchdog(lambda: channel(corpus, rng), timeout)
    if status == "hang":
        return CaseResult(case, "hang", f"exceeded {timeout}s watchdog")
    if status == "exc":
        if isinstance(value, NAMED_ERRORS):
            return CaseResult(case, "detected", type(value).__name__)
        return CaseResult(case, "unnamed",
                          f"{type(value).__name__}: {value}")
    outcome, note = value
    return CaseResult(case, outcome, note)


def run_campaign(seed: int = 0, cases: int = 200,
                 base_dir: "str | None" = None, backend: str = "ref",
                 timeout: float = 120.0, progress=None) -> CampaignReport:
    """Run a seeded campaign; deterministic case schedule per seed.

    ``progress(i, result)`` is called after each case (the CLI uses it).
    The corpus lives in ``base_dir`` (a fresh temp dir by default).
    """
    import tempfile

    cleanup = base_dir is None
    base_dir = base_dir or tempfile.mkdtemp(prefix="faultinject_")
    corpus = build_corpus(base_dir, backend=backend)
    rng = np.random.RandomState(seed)
    results = []
    try:
        for i in range(cases):
            channel = CHANNELS[i % len(CHANNELS)]
            result = run_case(channel, corpus,
                              int(rng.randint(0, 2 ** 31 - 1)),
                              timeout=timeout)
            results.append(result)
            if progress is not None:
                progress(i, result)
    finally:
        if cleanup:
            shutil.rmtree(base_dir, ignore_errors=True)
    return CampaignReport(results)
