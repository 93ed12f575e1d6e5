"""The port's spans (``repro_torch.core.trace``) on its read path.

Off, a span is one check of the profiler's state and the shared null
context: no ``record_function`` is built.  Under a CPU profiler, a
``Codec.decompress`` emits the documented names, each nested under exactly
one root span; the digest's span appears on a fresh payload only, no
transfer span opens on the CPU, and the output is bit for bit the one
without the profiler.
"""

import dataclasses

import pytest
import torch

from repro_torch.core import codec as codec_mod
from repro_torch.core import trace
from repro_torch.core.cache import compressed_digest
from repro_torch.core.codec import Codec, CodecConfig

ROOTS = ("repro_torch.session.plan_for", "repro_torch.session.decompress")
PLAN = {"repro_torch.plan", "repro_torch.plan.count",
        "repro_torch.plan.offsets"}
DECODE = {"repro_torch.decode", "repro_torch.decode.phase4",
          "repro_torch.dequantize"}
#: Decoder settings whose read paths carry spans, beside the default.
SETTINGS = {"tile": {}, "tuned": {"strategy": "tuned"},
            "padded": {"strategy": "padded"}, "fused": {"fused": True},
            "selfsync": {"method": "selfsync"},
            "naive_ref": {"method": "naive_ref"}}


def _field(shape=(5, 12, 18), seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).cumsum(0).cumsum(-1)


def _profiled(fn):
    """``fn()`` under a CPU profiler: its result and the program's spans
    as ``(name, start, end, thread)``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in prof.events() if e.name.startswith("repro_torch.")]
    return out, spans


def _roots_over(span, spans):
    name, lo, hi, thread = span
    return [s for s in spans if s[0] in ROOTS and s is not span
            and s[3] == thread and s[1] <= lo and hi <= s[2]]


def test_off_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("repro_torch.x") is trace.span("repro_torch.y", "a")
    assert trace.crossing("repro_torch.x.h2d", torch.device("cuda")) \
        is trace.span("repro_torch.x")
    codec = Codec(CodecConfig(device="cpu"))
    c = codec.compress(_field())
    codec.decompress(c)                     # every span of a read is off
    codec.decompress(dataclasses.replace(c))


def test_crossing_opens_only_off_the_host():
    host = torch.device("cpu")
    _, spans = _profiled(lambda: [
        trace.crossing("repro_torch.t.sync", host).__enter__(),
        trace.crossing("repro_torch.t.h2d", None).__enter__()])
    assert spans == []

    def card():
        with trace.crossing("repro_torch.t.h2d", torch.device("cuda")):
            pass
    _, spans = _profiled(card)
    assert [s[0] for s in spans] == ["repro_torch.t.h2d"]


@pytest.mark.parametrize("cache", [4096, 0], ids=["plan_cache", "no_cache"])
def test_decompress_spans(cache):
    codec = Codec(CodecConfig(device="cpu", plan_cache_size=cache))
    c = codec.compress(_field())
    want = Codec(CodecConfig(device="cpu")).decompress(
        dataclasses.replace(c))
    first, spans1 = _profiled(lambda: codec.decompress(c))
    second, spans2 = _profiled(lambda: codec.decompress(c))
    names1, names2 = {s[0] for s in spans1}, {s[0] for s in spans2}
    assert names1 == {ROOTS[1], "repro_torch.digest"} | PLAN | DECODE
    # The digest is memoized: only a fresh payload computes it.
    assert names2 == {ROOTS[1]} | DECODE | (PLAN if cache == 0 else set())
    for spans in (spans1, spans2):
        assert [s[0] for s in spans].count(ROOTS[1]) == 1
        for s in spans:
            assert len(_roots_over(s, spans)) == (s[0] not in ROOTS), s
    assert not any(s[0].endswith((".sync", ".h2d")) for s in spans1 + spans2)
    assert torch.equal(first, want) and torch.equal(second, want)
    assert codec_mod._digest_tag(c) == compressed_digest(c)[:12]
    assert codec_mod._digest_tag(dataclasses.replace(c)) is None


def test_plan_for_is_a_root():
    codec = Codec(CodecConfig(device="cpu", plan_cache_size=0))
    c = codec.compress(_field())
    plan, spans = _profiled(lambda: codec.plan_for(c))
    assert {s[0] for s in spans} == {ROOTS[0], "repro_torch.digest"} | PLAN
    assert all(len(_roots_over(s, spans)) == (s[0] not in ROOTS)
               for s in spans)
    out, spans = _profiled(lambda: codec.decompress(c, plan=plan))
    assert {s[0] for s in spans} == {ROOTS[1]} | DECODE
    assert torch.equal(out, codec.decompress(c))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_spans_of_each_decoder_nest_under_one_root(setting):
    cfg = CodecConfig(device="cpu", **SETTINGS[setting])
    codec = Codec(cfg)
    c = codec.compress(_field(seed=11))
    want = codec.decompress(c)
    out, spans = _profiled(lambda: codec.decompress(c))
    names = {s[0] for s in spans}
    assert {ROOTS[1], "repro_torch.decode", "repro_torch.decode.phase4"} \
        <= names
    # The fused decode dequantizes inside phase 4.
    assert ("repro_torch.dequantize" in names) != (setting == "fused")
    for s in spans:
        assert len(_roots_over(s, spans)) == (s[0] not in ROOTS), s
    assert not any(s[0].endswith((".sync", ".h2d")) for s in spans)
    assert out.dtype == want.dtype and torch.equal(out, want)


@pytest.mark.parametrize("shape", [(4000,), (40, 60), (5, 12, 18)])
def test_output_is_bit_equal_with_the_profiler_on(shape):
    codec = Codec(CodecConfig(device="cpu", plan_cache_size=0))
    c = codec.compress(_field(shape, seed=len(shape)))
    off = codec.decompress(c)
    on, spans = _profiled(lambda: codec.decompress(c))
    assert spans and torch.equal(on.view(torch.int32),
                                 off.view(torch.int32))
