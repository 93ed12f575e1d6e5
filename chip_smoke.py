#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --ab ROOT      # kernels vs another checkout

Drives the port's decode paths through ``Codec``, all on the card, at a
real data size on three fields made from ``--seed``:

  (a) a Hurricane-ISABEL-shaped 3-D field, float32[100, 500, 500];
  (b) a CESM-ATM-shaped 2-D field, float32[1800, 3600] (one CESM field of
      SDRBench, the paper's 2-D dataset);
  (c) a HACC-style 1-D field, float32[2**24] (HACC's fields hold 280 M
      values; cut to 2**24 to keep the run short).

All are compressed at the paper's setting, eb=1e-3 relative.  The paths:

  * two-pass, ``Codec(CodecConfig())``: gap-array plan (``count_subseq``
    kernel), tile decode-write (``decode_tiles`` kernel), dequantize;
  * fused, ``Codec(CodecConfig(fused=True))``: the same plan, then one
    kernel that decodes, dequantizes and reconstructs
    (``decode_tiles_fused`` for the 1-D field, ``decode_tiles_fused_nd``
    for the 2-D and 3-D ones), with no quant-code array in device memory;
  * padded, ``Codec(CodecConfig(strategy="padded"))``: the plan, the
    padded baseline decode (``decode_padded`` kernel: one padded row per
    subsequence, the original decoders' scattered writes), the compaction
    and dequantize as torch ops;
  * padded fused, ``strategy="padded", fused=True``: the padded decode,
    then one epilogue kernel that dequantizes and reconstructs
    (``dequant_reconstruct`` for the 1-D field, ``dequant_reconstruct_nd``
    for the 2-D and 3-D ones);
  * tuned, ``strategy="tuned"``: the sequences of each compression-ratio
    class decoded by ``decode_tiles`` with that class's tile (paper
    Alg. 2), at most ``t_high + 1`` dispatches a tensor;
  * batch, ``Codec().decompress_batch``: the three fields and 256 KV-cache
    pages shaped like Qwen3-0.6B's (float32[2, 8, 16, 128]: K/V x 8 KV
    heads x 16 tokens x head_dim 128), one ``decode_tiles`` dispatch per
    class across all 259 tensors, through one LUT merged from their 259
    codebooks (3.2 MB, read from device memory: it does not fit shared
    memory);
  * encode, ``Codec(CodecConfig(encode_backend="cuda")).compress`` of the
    three fields and the 256 KV pages: the device write path, with the
    ``lorenzo_quantize`` (float32 quantize and N-D Lorenzo residual),
    ``histogram`` and ``pack_tiles`` (bit-pack) kernels once a tensor;
  * reconstruct, ``ops.lorenzo_reconstruct`` of hacc1d's residuals: the
    ``reconstruct1d`` kernel (the quantizer's 1-D inverse);
  * chunked, Table V's baseline: each field's quant codes through cuSZ's
    coarse-grained coder (``encode_chunked``, then ``decode_chunked``:
    the ``decode_chunked`` kernel, one thread a chunk) at 16,384 and 2,048
    symbols a chunk, with its plain version made to raise;
  * tree, ``Codec.compress_tree`` / ``decompress_tree`` of a dict of the
    three fields, 256 KV pages, an int32 leaf, a ``None`` and a nested
    list: one ``decompress_batch`` call (``count_subseq``,
    ``decode_tiles``); store, the same compressed leaves written by
    ``ArchiveWriter`` and read by ``Archive.iter_decode`` cold (plans
    built) and warm (``decode_tiles`` only);
  * opt self-sync, ``Codec(CodecConfig(method="selfsync"))``: ``decompress``
    and ``Codec.decode(early_exit=True)`` of the three fields, the sync
    points found by self-synchronization (the ``selfsync_intra`` kernel,
    one launch a pass, the sequence heads chained between passes) and the
    tile decode-write (``decode_tiles``), with no ``count_subseq``;
  * ori self-sync, ``method="selfsync", strategy="padded"`` with
    ``Codec.decode(early_exit=False)``: every pass runs ``sps`` rounds, then
    the padded decode (``decode_padded``);
  * model, for qwen3-0.6b (dense) and rwkv6-3b (rwkv) at full width with
    random weights from ``--seed`` on the card: the prefill forward
    (``steps.make_prefill_step``, B 4, S 1024, bf16), whose attention runs
    the ``flash_attention`` kernel (one launch a layer) and whose time-mix
    runs ``gla_time_mix`` (one a layer); ``launch.serve.main`` at the
    reference's defaults (batch 4, prompt 32, 32 generated), whose rwkv
    decode steps run ``gla_time_mix`` (one a layer a step) and whose dense
    decode runs no kernel; and step decode against the forward in float32
    (B 2, 256 tokens);
  * pager, qwen3-0.6b's prefill at B 4 x 1024 kept as its decode cache
    (k, v bf16 (28, 4, 1024, 8, 128)), tokens [256, 768) offloaded by
    ``KVPager`` through a "cuda"-encode codec (``lorenzo_quantize``,
    ``histogram``, ``pack_tiles``) and paged back in (``count_subseq``,
    ``decode_tiles``).

The script

  * builds the CUDA kernels (``src/repro_torch/csrc``) for sm_90a;
  * zeroes every kernel's launch count just before each path, drives it on
    its tensors, and fails if a kernel of that path was not launched (or a
    kernel of another path was);
  * checks each field: the codes decoded on the card equal the quantization
    codes ``compress`` encoded, bit for bit; ``max|x - x'| <= eb_effective``;
    the fused, padded, padded fused and tuned outputs equal the two-pass
    output bit for bit, with ``fused_dispatches >= 1`` and
    ``fused_fallbacks == 0`` on the fused paths; each kernel equals its
    plain PyTorch version on the card at the path's inputs, bit for bit;
    ``count_subseq``, ``decode_padded`` and ``selfsync_intra`` on
    isabel3d's windows through its table widened to ``2**LONG_MAX_LEN``
    entries (their device-memory LUT variants) equal the same kernels with
    the table in shared memory and their plain versions, bit for bit;
    every batch output equals its tensor's own ``decompress``, with at most
    ``t_high + 1`` decode-write dispatches for the whole batch; every
    "cuda"-encoded payload decodes to the codes of its quantize kernel and
    reconstructs within ``eb_effective``, with no encode fallback; a
    lattice field (values exactly k * 2eb) encodes byte for byte as the
    "ref" encode does; the reconstruct round trip stays within eb plus one
    float32 spacing; the self-sync plans' counts equal the gap plan's and
    their starts the gap starts below total_bits, for both ``early_exit``
    values, and the self-sync codes and floats equal the two-pass output
    bit for bit; each model kernel equals its plain version at layer 0's
    inputs and on the random cases of ``repro_torch.testing.kernel_cases``
    (flash in bf16 within one bf16 ulp of the output's scale, in float32
    within 2e-5; gla within 1e-4 of the output's scale); the prefill
    logits are finite and of the expected shape; the float32 step-decode
    logits are within ``DECODE_F32_TOL`` of the forward's at every
    position, with equal argmax wherever the top-2 gap exceeds it;
    ``decode_chunked`` equals its plain version bit for bit at every block
    width it takes and its first n codes equal ``Codec.decode``'s; the
    tree's decoded leaves equal ``decompress_batch`` of the same payloads
    bit for bit and every other leaf comes back as the same object; the
    archive reads back bit for bit, the warm read builds zero plans and
    hits the codebook cache; the paged tokens come back within the
    codec's bound (``eb_effective`` with the cast to bf16), zeroed in
    between, and a second page-in builds zero plans;
  * prints CUDA-event times of each kernel, its plain version and its byte
    bound, the two-pass dequantize, the plan and the whole ``decompress`` of
    every path; the decode throughput (phases 1-4) and the ``decompress``
    throughputs in GB/s of quant codes (2 B per code); ``compress`` with the
    "ref" and "cuda" encode backends; the gap and self-sync plan times, the
    passes and rounds of the self-sync and the decode throughput of ori and
    opt self-sync; the model phase's prefill ms and tokens/s, serve
    tokens/s and peak memory a config, the model kernels' times beside
    their plain versions' and ``scaled_dot_product_attention``'s (the
    yardstick of ``flash_attention``, timed here and used nowhere in the
    port), ``torch.cumsum`` of hacc1d's int32 residuals (the yardstick of
    ``dequant_reconstruct`` and ``reconstruct1d``, whose device times
    ``launch_split`` also reads), and ``gla_time_mix`` at serve's decode
    shape (BH 160, S 1, the state in: back to back through the wrapper,
    and the kernel's device time) beside its byte bound; a KV page's ``lorenzo_quantize``,
    ``histogram`` and ``pack_tiles`` launch split into the wrapper's host
    time and the kernel's device time (``launch_split``, for
    ``histogram`` on the fields too); the card's name and power limit;
    ``decode_chunked``'s ms at each block width, GB/s of codes and stored
    bytes beside the gap stream's, and each Table V decoder's speedup over
    it (``table V``); the tree, archive write and cold and warm read
    times, and the pager's offload, page-in and ratio (``store and
    pager``); and a ``kernels`` JSON line, one row a TPU kernel of the
    repo (fourteen) and one for the yardstick ``decode_chunked``
    (``replaces`` null, ``yardstick`` the reference function), with rows
    5 and 7 on both N-D fields, row 10 on all three
    fields, rows 8, 10 and 11 also on one KV page, and rows 1, 3 and 12
    also through their device-memory LUT.  Each time is read after
    warm-up, once two readings in a row agree.

The last line of standard output is ``{"ok": true, "device": {...}}``.  The
script exits non-zero, printing no result, when PyTorch sees no CUDA device
or when any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Published HBM3 bandwidth of the H100 SXM (bytes/s), for the byte bounds.
HBM_BYTES_PER_S = 3.35e12
#: Published dense peaks of the H100 SXM by input type (FLOP/s): bf16 on
#: the tensor cores, float32 without them.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: The TPU kernels these CUDA kernels replace (file:line of the def).
REPLACES = {"count_subseq": "src/repro/kernels/huffman_decode.py:52",
            "decode_tiles": "src/repro/kernels/huffman_decode.py:105",
            "decode_padded": "src/repro/kernels/huffman_decode.py:157",
            "decode_tiles_fused": "src/repro/kernels/fused_decode.py:155",
            "decode_tiles_fused_nd": "src/repro/kernels/fused_decode.py:222",
            "dequant_reconstruct": "src/repro/kernels/fused_decode.py:295",
            "dequant_reconstruct_nd":
                "src/repro/kernels/fused_decode.py:343",
            "lorenzo_quantize": "src/repro/kernels/lorenzo.py:43",
            "reconstruct1d": "src/repro/kernels/lorenzo.py:89",
            "histogram": "src/repro/kernels/histogram.py:36",
            "pack_tiles": "src/repro/kernels/huffman_encode.py:74",
            "selfsync_intra": "src/repro/kernels/huffman_selfsync.py:80",
            "flash_attention": "src/repro/kernels/flash_attn.py:83",
            "gla_time_mix": "src/repro/kernels/rwkv_gla.py:52"}
#: The kernels of the port that replace no TPU kernel: the yardsticks, by
#: the reference function whose output they compute.
YARDSTICKS = {"decode_chunked": "src/repro/core/huffman/decode.py:372"}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu"
           for name in (*REPLACES, *YARDSTICKS)}
SOURCES["flash_attention"] = "src/repro_torch/csrc/flash_attn.cu"
#: The kernels each path must launch; every other kernel must not launch.
TWO_PASS_KERNELS = ("count_subseq", "decode_tiles")
FUSED_KERNELS = ("count_subseq", "decode_tiles_fused",
                 "decode_tiles_fused_nd")
PADDED_KERNELS = ("count_subseq", "decode_padded")
PADDED_FUSED_KERNELS = ("count_subseq", "decode_padded",
                        "dequant_reconstruct", "dequant_reconstruct_nd")
TUNED_KERNELS = ("count_subseq", "decode_tiles")
BATCH_KERNELS = ("count_subseq", "decode_tiles")
ENCODE_KERNELS = ("lorenzo_quantize", "histogram", "pack_tiles")
RECONSTRUCT_KERNELS = ("reconstruct1d",)
SELFSYNC_KERNELS = ("selfsync_intra", "decode_tiles")
ORI_SELFSYNC_KERNELS = ("selfsync_intra", "decode_padded")
CHUNKED_KERNELS = ("decode_chunked",)
TREE_KERNELS = ("count_subseq", "decode_tiles")
STORE_READ_KERNELS = ("count_subseq", "decode_tiles")
STORE_WARM_KERNELS = ("decode_tiles",)
PAGER_KERNELS = ("lorenzo_quantize", "histogram", "pack_tiles",
                 "count_subseq", "decode_tiles")
#: selfsync_intra's times beside its bound in the kernels line: the chained
#: heads, no early exit (ori), and the decode-work yardstick (rounds run x
#: count_subseq's time on the same stream).
SELFSYNC_EXTRA_KEYS = ("chained_heads_ms", "no_early_exit_ms",
                       "count_subseq_ms", "rounds_mean", "decode_work_ms",
                       "no_early_exit_rounds_mean",
                       "no_early_exit_decode_work_ms")
HACC_VALUES = 280_953_867
#: The model phase: the two configs served at full width, the prefill
#: shape, the float32 forward-against-decode shape and its gate.
MODEL_ARCHS = ("qwen3-0.6b", "rwkv6-3b")
PREFILL_BATCH, PREFILL_LEN = 4, 1024
CONSIST_BATCH, CONSIST_LEN = 2, 256
#: Measured on an H100 80GB HBM3 at --seed 0: 6.7e-6 (qwen3-0.6b, logit
#: scale 3.2) and 8.6e-5 (rwkv6-3b, scale 5.9), sums in another order only.
DECODE_F32_TOL = 1e-3
#: The code-length cap at which the three kernels that stage a LUT of
#: 2**max_len entries run their device-memory variants (the reference
#: accepts max_len 1-24 on every backend).
LONG_MAX_LEN = 20
#: KV-cache pages of the batch phase, each shaped like one Qwen3-0.6B page:
#: (K/V, KV heads, tokens, head_dim).
N_PAGES = 256
PAGE_SHAPE = (2, 8, 16, 128)
#: The encode phase's lattice field: values exactly k * 2eb (eb = 2**-10),
#: 2**22 of them, which the float32 and float64 quantizers map alike.
LATTICE_SHAPE = (64, 256, 256)
LATTICE_EB = 2.0 ** -10
#: cuSZ's chunk sizes for the chunked baseline: its default, then 2,048.
CHUNK_SIZES = (16384, 2048)
#: The token span the pager offloads from qwen3-0.6b's 1,024-token cache.
PAGE_SPAN = (256, 768)


def make_fields(seed: int):
    """The three fields: smooth (Lorenzo-predictable) plus white noise of
    2e-3 of the unit peak, float32, made with numpy from ``seed``."""
    import numpy as np

    from repro_torch.data.pipeline import smooth_field

    fields = {}
    for name, shape, s in (("isabel3d", (100, 500, 500), seed),
                           ("cesm2d", (1800, 3600), seed + 2),
                           ("hacc1d", (1 << 24,), seed + 1)):
        x = smooth_field(shape, seed=s)
        noise = np.random.default_rng(s + 1000).standard_normal(shape)
        fields[name] = (x + np.float32(2e-3) * noise.astype(np.float32))
    return fields


def make_pages(seed: int):
    """The batch phase's KV pages: smooth fields plus white noise of 1e-2
    of the unit peak, float32, made with numpy from ``seed``."""
    import numpy as np

    from repro_torch.data.pipeline import smooth_field

    rng = np.random.default_rng(seed + 2000)
    return [smooth_field(PAGE_SHAPE, seed=seed + 3000 + i)
            + np.float32(1e-2) * rng.standard_normal(PAGE_SHAPE).astype(
                np.float32) for i in range(N_PAGES)]


def run_path(name: str, kernels, drive):
    """Zero every launch count, run ``drive()``, read the counts; fail if a
    kernel of the path was not launched or another kernel was.  Returns
    ``(drive(), counts)``."""
    import torch

    from repro_torch.kernels import launches

    launches.reset()
    out = drive()
    torch.cuda.synchronize()
    counts = launches.counts()
    print(f"{name} path launches: {json.dumps(counts)}")
    for kname, n in counts.items():
        if kname in kernels:
            require(n > 0, f"kernel {kname} was not launched on the {name} "
                    f"path")
        else:
            require(n == 0, f"kernel {kname} was launched on the {name} path")
    return out, counts


#: ``cuda_ms`` reads until two readings in a row agree within this share,
#: or it has taken ``TIMING_MAX_READS`` readings.
TIMING_AGREE = 0.05
TIMING_MAX_READS = 6


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, warmed up until
    two readings in a row (of ``iters`` calls each) agree within
    ``TIMING_AGREE``, or ``TIMING_MAX_READS`` readings: the last reading.
    Kernel times can read 1.6-2.2x slow at the start of a run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    prev = None
    for _ in range(TIMING_MAX_READS):
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / iters
        if prev is not None and abs(ms - prev) <= TIMING_AGREE * min(
                ms, prev):
            break
        prev = ms
    return ms


#: GPU clock cycles of the sleep kernel that ``launch_split`` queues ahead
#: of its launches (~10 ms at the H100's clocks): the host must enqueue
#: them all before it ends.
SPLIT_SLEEP_CYCLES = 20_000_000


#: Calls of a wrapper's cached geometry lookup timed on the host.
GEOMETRY_CALLS = 10_000


def launch_split(fn, iters: int = 50) -> dict:
    """Where a launch's time goes: ``wrapper_ms`` back to back through the
    wrapper (``cuda_ms``); ``host_ms`` the wrapper's own host time a call,
    ``time.perf_counter`` around ``iters`` calls that queue without
    waiting (the launch queue holds them all), the least of five
    readings; and ``device_ms`` the device time a launch, CUDA events
    around ``iters`` launches queued behind a sleep kernel, so they run
    back to back with the host's work already done, the least of three
    readings.  Fails if the host took longer to enqueue than the sleep
    lasted."""
    import torch

    wrapper = cuda_ms(fn, iters)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / iters)
    slept = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    device = []
    for _ in range(3):
        torch.cuda.synchronize()
        slept.record()
        torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        torch.cuda.synchronize()
        sleep_ms = slept.elapsed_time(start)
        require(enqueue_ms < sleep_ms, f"launch_split: the host took "
                f"{enqueue_ms:.2f} ms to enqueue, the sleep {sleep_ms:.2f} ms")
        device.append(start.elapsed_time(stop) / iters)
    torch.cuda.synchronize()
    return {"wrapper_ms": wrapper, "host_ms": min(host),
            "device_ms": min(device)}


def kernel_inputs(codec, c):
    """The inputs the two-pass path gives each kernel for payload ``c``."""
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import ops

    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, c.device)
    s0 = ops._tile_inputs(plan.offsets, c.stream.n_subseq, c.n_symbols,
                          codec.config.tile_syms)
    count_args = (c.stream.units, plan.start_bits, plan.end_bits,
                  c.stream.total_bits, luts.dec_sym, luts.dec_len,
                  luts.max_len)
    tile_args = (c.stream.units, plan.start_bits, plan.end_bits,
                 plan.offsets, s0, c.stream.total_bits, luts.dec_sym,
                 luts.dec_len, luts.max_len, codec.config.tile_syms,
                 hp.ss_max_for_tile(codec.config.tile_syms, luts.max_len),
                 c.n_symbols)
    return count_args, tile_args


def fused_inputs(codec, c):
    """The fused kernel the fused path launches for ``c``, its plain
    version, and the inputs it gives them."""
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import ops

    plan = codec.plan_for(c)
    luts = hp._as_luts(c.codebook, c.device)
    tile = codec.config.tile_syms
    return ops.fused_tile_inputs(
        c.stream.units, luts.dec_sym, luts.dec_len, plan.start_bits,
        plan.end_bits, plan.offsets, c.stream.total_bits, luts.max_len,
        c.n_symbols, tile, hp.ss_max_for_tile(tile, luts.max_len),
        c.outlier_pos, c.outlier_val, c.eb, c.radius, shape=c.shape,
        out_dtype=c.dtype)


def selfsync_kernel_args(c):
    """``selfsync_intra``'s arguments on payload ``c``'s stream at the
    self-sync path's two kinds of heads, without ``early_exit``: zero (the
    first pass) and chained (the heads of the last pass, row-local)."""
    import torch

    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import ops

    stream = c.stream
    luts = hp._as_luts(c.codebook, c.device)
    sps, n_seq = stream.subseqs_per_seq, stream.n_seq
    starts, _, _ = ops.selfsync_sync(
        stream.units, luts.dec_sym, luts.dec_len, stream.total_bits,
        stream.n_subseq, sps, luts.max_len, early_exit=True)
    heads = (starts.reshape(n_seq, sps)[:, :1]
             - torch.arange(n_seq, dtype=torch.int32,
                            device=c.device)[:, None] * (128 * sps))
    rest = (stream.total_bits, luts.dec_sym, luts.dec_len, luts.max_len, sps)
    return ((stream.units, torch.zeros_like(heads), *rest),
            (stream.units, heads.contiguous(), *rest))


def max_abs_diff(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bits(t):
    """An integer view of ``t`` with its bits (unsigned and float tensors
    compared through signed views, which every build compares on the card)."""
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def same(a, b) -> bool:
    """Bit-for-bit equality."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(bits(a), bits(b))


def max_abs_err(a, b) -> float:
    """Largest absolute difference of two float tensors."""
    return float((a.double() - b.double()).abs().max())


def require(ok: bool, what: str) -> None:
    """A check of the run: raises (exit code 1, no result line) if false."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def merged_lut_args(cs, plans):
    """``decode_tiles``' arguments at the largest class dispatch of a
    ``decode_batch`` of payloads ``cs`` (a recording backend replays the
    batch, whose decode must equal the "cuda" backend's): ``(args, calls,
    replay)``."""
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import ops

    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return ops.decode_write_tiles(*a, **kw)

    cuda_be = hp.get_backend("cuda")
    rec = hp.DecodeBackend(name="record", count_fn=cuda_be.count_fn,
                           tiles_fn=record, padded_fn=cuda_be.padded_fn)
    batch = ([c.stream for c in cs], [c.codebook for c in cs],
             [c.n_symbols for c in cs])
    replay = hp.decode_batch(*batch, plans=plans, backend=rec)
    require(all(same(r, q) for r, q in zip(
        replay, hp.decode_batch(*batch, plans=plans, backend="cuda"))),
            "batch: replayed decode differs")
    (units, ds, dl, starts, ends, offsets, total_bits, max_len, n_out, tile,
     ss_max), kw = max(calls, key=lambda call: call[0][8])
    s0 = ops._tile_inputs(offsets, starts.shape[0], n_out, tile)
    return ((units, starts, ends, offsets, s0, total_bits, ds, dl, max_len,
             tile, ss_max, n_out, kw["lut_base"]), calls, replay)


def class_tile_args(codec, c):
    """``decode_tiles``' arguments over all of payload ``c`` at the tile of
    its most populous compression-ratio class (the tuned strategy's
    buffer for most of its sequences): ``(tile, args)``."""
    import numpy as np

    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import ops

    plan = codec.plan_for(c)
    classes = plan.classes
    tile = hp.tile_for_class(int(np.bincount(classes.classes).argmax()),
                             classes.t_high)
    _, args = kernel_inputs(codec, c)
    s0 = ops._tile_inputs(plan.offsets, c.stream.n_subseq, c.n_symbols, tile)
    luts = hp._as_luts(c.codebook, c.device)
    return tile, (*args[:4], s0, *args[5:9], tile,
                  hp.ss_max_for_tile(tile, luts.max_len), args[11])


def widened_lut(luts, max_len: int):
    """Payload ``luts``' decode table re-indexed by ``max_len`` bits: entry
    i is the entry of its first ``luts.max_len`` bits, so a decode at
    ``max_len`` reads the same codewords, lands at the same positions and
    writes the same codes as at ``luts.max_len``, from a ``2**max_len``-entry
    table (past shared memory from max_len 17 or 18)."""
    import torch

    reps = 1 << (max_len - luts.max_len)
    sym = luts.dec_sym.view(torch.int16).repeat_interleave(reps)
    return (sym.view(torch.uint16).contiguous(),
            luts.dec_len.repeat_interleave(reps).contiguous())


def long_code_kernels(codec, c, max_len: int = LONG_MAX_LEN,
                      refusal_ok: bool = False) -> dict:
    """``count_subseq``, ``decode_padded`` and ``selfsync_intra`` (zero
    heads, ``early_exit``) on payload ``c``'s windows (``codec``'s gap
    plan), at the codebook's max_len (the LUT staged in shared memory) and
    through the same table widened to ``max_len`` bits (:func:`widened_lut`:
    the device-memory variants).  Each variant is held against the other
    and against the plain version at ``max_len``, bit for bit; returns
    their times (ms).  A kernel that refuses the wide table fails the run,
    unless ``refusal_ok`` (timing another tree, one that may predate the
    variants): its time is then None."""
    import torch

    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import huffman_decode as K
    from repro_torch.kernels import huffman_selfsync as S

    luts = hp._as_luts(c.codebook, c.device)
    plan = codec.plan_for(c)
    ds, dl = widened_lut(luts, max_len)
    stream = c.stream
    narrow = (stream.units, plan.start_bits, plan.end_bits,
              stream.total_bits, luts.dec_sym, luts.dec_len, luts.max_len)
    wide = narrow[:4] + (ds, dl, max_len)
    heads = torch.zeros((stream.n_seq, 1), dtype=torch.int32, device=c.device)
    sps = stream.subseqs_per_seq
    s_narrow = (stream.units, heads, stream.total_bits, luts.dec_sym,
                luts.dec_len, luts.max_len, sps, True)
    s_wide = (stream.units, heads, stream.total_bits, ds, dl, max_len, sps,
              True)
    out = {"max_len": max_len, "lut_entries": 1 << max_len}
    for key, kernel, plain, a, b in (
            ("count_subseq", K.count_subseq, K.count_subseq_plain, narrow,
             wide),
            ("decode_padded", K.decode_padded, K.decode_padded_plain, narrow,
             wide),
            ("selfsync_intra", S.selfsync_intra, S.selfsync_intra_plain,
             s_narrow, s_wide)):
        out[f"{key}_smem_ms"] = cuda_ms(lambda: kernel(*a), 20)
        try:
            got = kernel(*b)
        except ValueError as e:
            require(refusal_ok, f"{key} refused a {1 << max_len}-entry LUT: "
                    f"{e}")
            out[f"{key}_global_ms"] = None
            continue
        want = kernel(*a)
        require(all(same(x, y) for x, y in zip(got, want)),
                f"{key} at a {1 << max_len}-entry LUT differs from the same "
                f"table at max_len {luts.max_len}")
        require(all(same(x, y) for x, y in zip(got, plain(*b))),
                f"{key} at a {1 << max_len}-entry LUT differs from its "
                f"plain version")
        out[f"{key}_global_ms"] = cuda_ms(lambda: kernel(*b), 20)
    return out


def run_batch(seed: int, results, xs) -> dict:
    """The batch phase: ``Codec().decompress_batch`` over the three fields
    and ``N_PAGES`` KV pages, its launch check and output checks, the
    merged-LUT ``decode_tiles`` launch against its plain version, and its
    times.  Prints and returns one ``batch`` row."""
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.core.sz import compressor
    from repro_torch.kernels import huffman_decode as K

    t0 = time.perf_counter()
    pages = [torch.from_numpy(p).cuda() for p in make_pages(seed)]
    base = Codec()
    cs = [c for _, c, _, _, _ in results.values()]
    cs += [base.compress(p) for p in pages]
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    codec = Codec()

    def drive():
        codec.reset_stats()
        return codec.decompress_batch(cs), dict(codec.stats)

    (outs, stats), counts = run_path("batch", BATCH_KERNELS, drive)
    t_high = codec.config.t_high
    require(stats["decode_write_dispatches"] <= t_high + 1,
            f"batch: {stats['decode_write_dispatches']} decode-write "
            f"dispatches for {len(cs)} tensors, more than t_high + 1")
    lut = len(cs) << max(int(c.codebook.max_len) for c in cs)
    require(not K.decode_tiles_lut_in_smem(hp.OVERFLOW_TILE, lut),
            f"batch: a merged LUT of {lut} entries fits shared memory; the "
            f"device-memory LUT variant was not exercised")
    wants = [y for _, _, y, _, _ in results.values()]
    wants += [base.decompress(c) for c in cs[len(results):]]
    for i, (y, w) in enumerate(zip(outs, wants)):
        require(y.device.type == "cuda" and same(y, w),
                f"batch: output {i} differs from its own decompress")
    for c, x in zip(cs[len(results):], pages):
        err = float((base.decompress(c).double() - x.double()).abs().max())
        require(err <= c.eb_effective, f"batch: a page's max|x - x'| {err}")

    # The merged-LUT tile kernel at the batch's largest class dispatch,
    # against its plain version.
    plans = [codec.plan_for(c) for c in cs]
    targs, calls, replay = merged_lut_args(cs, plans)
    tile, ss_max, n_out = targs[9], targs[10], targs[11]
    ds = targs[6]
    kt = K.decode_tiles(*targs)
    pt = K.decode_tiles_plain(*targs)
    require(same(kt, pt), "batch: merged-LUT decode_tiles differs from its "
            "plain version")
    torch.cuda.synchronize()
    payload = sum(c.stream.total_bits for c in cs) / 8
    n_codes = sum(c.n_symbols for c in cs)
    row = {
        "tensors": len(cs), "pages": N_PAGES,
        "page_shape": list(PAGE_SHAPE), "codes": n_codes,
        "merged_lut_entries": lut, "compress_pages_s": t_compress,
        "launches": counts, "decode_write_dispatches":
            stats["decode_write_dispatches"],
        "class_dispatches": [(call[0][9], call[0][8]) for call in calls],
        "merged_lut_kernel": {
            "tile": tile, "codes": n_out, "ss_max": ss_max,
            "lut_in_smem": K.decode_tiles_lut_in_smem(tile, ds.numel()),
            "ms": cuda_ms(lambda: K.decode_tiles(*targs), 20),
            "plain_ms": cuda_ms(lambda: K.decode_tiles_plain(*targs), 1),
            "max_abs_err": max_abs_diff(kt, pt)},
        "decompress_batch_cached_plan_ms": cuda_ms(
            lambda: codec.decompress_batch(cs), 5),
        # its two halves: the class-merged decode, the per-tensor dequantize
        "decode_batch_cached_plan_ms": cuda_ms(
            lambda: hp.decode_batch([c.stream for c in cs],
                                    [c.codebook for c in cs],
                                    [c.n_symbols for c in cs], plans=plans,
                                    backend="cuda"), 5),
        "dequantize_each_ms": cuda_ms(
            lambda: [compressor._dequantize(c, q) for c, q in zip(cs, replay)],
            5),
        "decompress_each_cached_plan_ms": cuda_ms(
            lambda: [codec.decompress(c) for c in cs], 3),
        "decompress_batch_with_plans_ms": cuda_ms(
            lambda: Codec(CodecConfig()).decompress_batch(cs), 3),
        "payload_bytes": payload,
    }
    row["decompress_batch_gbps"] = 2 * n_codes / (
        row["decompress_batch_cached_plan_ms"] * 1e-3) / 1e9
    print(f"batch {json.dumps(row)}")
    return row


def run_selfsync(results) -> dict:
    """The self-sync phase: opt self-sync (``method="selfsync"``,
    ``decompress`` and ``Codec.decode(early_exit=True)``) and ori self-sync
    (``strategy="padded"``, ``Codec.decode(early_exit=False)``) on the three
    fields, each with its launch check; the self-sync plans against the gap
    plan; ``selfsync_intra`` against its plain version on isabel3d, at the
    first pass's heads and the chained ones, for both ``early_exit`` values;
    and the times.  Prints one ``selfsync`` row per field and returns
    ``{"fields": rows, "launches": ..., "ori_launches": ...}``."""
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import huffman_decode as K
    from repro_torch.kernels import huffman_selfsync as S
    from repro_torch.kernels import ops

    opt = Codec(CodecConfig(method="selfsync"))
    ori = Codec(CodecConfig(method="selfsync", strategy="padded"))

    def drive_opt():
        return {name: (opt.decompress(c),
                       opt.decode(c.stream, c.codebook, c.n_symbols,
                                  early_exit=True))
                for name, (_, c, _, _, _) in results.items()}

    def drive_ori():
        return {name: ori.decode(c.stream, c.codebook, c.n_symbols,
                                 early_exit=False)
                for name, (_, c, _, _, _) in results.items()}

    opt_out, counts = run_path("opt self-sync", SELFSYNC_KERNELS, drive_opt)
    ori_out, ori_counts = run_path("ori self-sync", ORI_SELFSYNC_KERNELS,
                                   drive_ori)

    rows = {}
    for name, (codec, c, y, _, _) in results.items():
        stream, book, n = c.stream, c.codebook, c.n_symbols
        gap_codes = codec.decode(stream, book, n)
        oy, ocodes = opt_out[name]
        require(same(oy, y), f"{name}: opt self-sync decompress differs "
                f"from the two-pass output")
        require(same(ocodes, gap_codes) and same(ori_out[name], gap_codes),
                f"{name}: self-sync codes differ from the two-pass codes")
        gap_plan = codec.plan_for(c)
        below = gap_plan.start_bits < stream.total_bits
        for ee in (True, False):
            plan = hp.build_plan(stream, book, method="selfsync",
                                 backend="cuda", early_exit=ee)
            require(same(plan.counts, gap_plan.counts)
                    and same(plan.start_bits[below],
                             gap_plan.start_bits[below]),
                    f"{name}: self-sync plan (early_exit={ee}) differs from "
                    f"the gap plan")
        luts = hp._as_luts(book, c.device)
        sps = stream.subseqs_per_seq
        sync_args = (stream.units, luts.dec_sym, luts.dec_len,
                     stream.total_bits, stream.n_subseq, sps, luts.max_len)
        n_seq = stream.n_seq
        row = {"field": name, "n_subseq": stream.n_subseq, "n_seq": n_seq}
        for ee, key in ((True, "early_exit"), (False, "no_early_exit")):
            before = S.selfsync_intra.launches
            _, _, rounds = ops.selfsync_sync(*sync_args, early_exit=ee)
            passes = S.selfsync_intra.launches - before
            total = int(rounds.sum())
            row[key] = {
                "passes": passes,
                "rounds_mean_per_seq_per_pass": total / passes / n_seq,
                "rounds_max_per_seq_per_pass": int(rounds.max()) / passes,
                "total_rounds_mean_per_seq": total / n_seq,
                "total_rounds_max_per_seq": int(rounds.max()),
                "sync_ms": cuda_ms(
                    lambda ee=ee: ops.selfsync_sync(*sync_args,
                                                    early_exit=ee), 5),
                "plan_ms": cuda_ms(lambda ee=ee: hp.build_plan(
                    stream, book, method="selfsync", backend="cuda",
                    early_exit=ee), 5)}
        row["gap_plan_ms"] = cuda_ms(
            lambda: codec.build_plan(stream, book), 5)
        # The kernel against its plain version at the path's inputs: the
        # first pass's heads (zero) and the chained heads (the last pass's).
        if name == "isabel3d":
            zero, chained = selfsync_kernel_args(c)
            errs = []
            for args in (zero, chained):
                for ee in (True, False):
                    got = S.selfsync_intra(*args, ee)
                    want = S.selfsync_intra_plain(*args, ee)
                    require(all(same(a, b) for a, b in zip(got, want)),
                            f"{name}: selfsync_intra (early_exit={ee}) "
                            f"differs from its plain version")
                    errs += [max_abs_diff(a, b) for a, b in zip(got, want)]
            # The decode-work yardstick: a round decodes every window once,
            # through the lane loop count_subseq runs over the same windows.
            count_args, _ = kernel_inputs(codec, c)
            count_ms = cuda_ms(lambda: K.count_subseq(*count_args), 20)
            opt_rounds = int(S.selfsync_intra(*zero, True)[3].sum())
            ori_rounds = int(S.selfsync_intra(*chained, False)[3].sum())
            opt_rounds, ori_rounds = opt_rounds / n_seq, ori_rounds / n_seq
            row["selfsync_intra"] = {
                "ms": cuda_ms(lambda: S.selfsync_intra(*zero, True), 20),
                "plain_ms": cuda_ms(
                    lambda: S.selfsync_intra_plain(*zero, True), 1),
                "chained_heads_ms": cuda_ms(
                    lambda: S.selfsync_intra(*chained, True), 20),
                "no_early_exit_ms": cuda_ms(
                    lambda: S.selfsync_intra(*chained, False), 20),
                "bound_ms": (stream.total_bits / 8 + 8 * n_seq
                             + 12 * stream.n_subseq) / HBM_BYTES_PER_S * 1e3,
                "count_subseq_ms": count_ms,
                "rounds_mean": opt_rounds,
                "decode_work_ms": opt_rounds * count_ms,
                "no_early_exit_rounds_mean": ori_rounds,
                "no_early_exit_decode_work_ms": ori_rounds * count_ms,
                "max_abs_err": max(errs)}
        # Phases 1-4 of each decoder, over the quant-code bytes.
        for key, fn in (
                ("gap_decode_ms", lambda: codec.decode(stream, book, n)),
                ("opt_decode_ms", lambda: opt.decode(stream, book, n,
                                                     early_exit=True)),
                ("ori_decode_ms", lambda: ori.decode(stream, book, n,
                                                     early_exit=False))):
            row[key] = cuda_ms(fn, 3)
            row[key.replace("_ms", "_gbps")] = c.quant_code_bytes / (
                row[key] * 1e-3) / 1e9
        rows[name] = row
        print(f"selfsync {json.dumps(row)}")
    torch.cuda.synchronize()
    return {"fields": rows, "launches": counts, "ori_launches": ori_counts}


def make_lattice(seed: int):
    """The lattice field: a smooth field on the 2eb lattice with 64 spikes
    past the radius (outliers), float32 made with numpy from ``seed``."""
    import numpy as np

    from repro_torch.data.pipeline import smooth_field

    k = np.rint(smooth_field(LATTICE_SHAPE, seed=seed + 4000) * 2000)
    rng = np.random.default_rng(seed + 4000)
    k.reshape(-1)[rng.choice(k.size, size=64, replace=False)] += 5000
    return k.astype(np.float32) * np.float32(2 * LATTICE_EB)


def same_payload(a, b) -> bool:
    """Two ``Compressed`` with the same stream, outliers and codebook."""
    import numpy as np

    sa, sb = a.stream, b.stream
    return (all(same(getattr(sa, f), getattr(sb, f))
                for f in ("units", "gaps", "counts", "seq_counts"))
            and (sa.total_bits, sa.n_symbols) == (sb.total_bits, sb.n_symbols)
            and same(a.outlier_pos, b.outlier_pos)
            and same(a.outlier_val, b.outlier_val)
            and np.array_equal(a.codebook.enc_code, b.codebook.enc_code)
            and np.array_equal(a.codebook.enc_len, b.codebook.enc_len))


def run_encode(seed: int, xs) -> dict:
    """The encode phase: ``Codec(encode_backend="cuda").compress`` of the
    three fields and ``N_PAGES`` KV pages, its launch and counter checks,
    each payload decoded back to its quantizer's codes, the lattice field
    against the "ref" encode, each write-path kernel against its plain
    version, and the times.  Then the reconstruct phase: 1-D
    ``ops.lorenzo_reconstruct`` of hacc1d's residuals on the
    ``reconstruct1d`` kernel.  Prints one ``encode`` row per field and
    returns ``{"fields": rows, "launches": ..., "reconstruct_launches":
    ...}``."""
    import numpy as np
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.core.sz import compressor, lorenzo
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels import huffman_encode as E
    from repro_torch.kernels import lorenzo as L
    from repro_torch.kernels import ops

    pages = [torch.from_numpy(p).cuda() for p in make_pages(seed)]
    tensors = list(xs.items()) + [(f"page{i}", p)
                                  for i, p in enumerate(pages)]
    torch.cuda.synchronize()
    codec = Codec(CodecConfig(encode_backend="cuda"))

    def drive():
        codec.reset_stats()
        t0 = time.perf_counter()
        out = [codec.compress(x) for _, x in tensors]
        torch.cuda.synchronize()
        return out, dict(codec.stats), time.perf_counter() - t0

    (cs, stats, t_all), counts = run_path("encode", ENCODE_KERNELS, drive)
    n = len(tensors)
    for kname in ENCODE_KERNELS:
        require(counts[kname] == n, f"encode: {kname} launched "
                f"{counts[kname]} times for {n} tensors")
    require(stats["encode_fallbacks"] == 0
            and stats["encode_dispatches"] == n,
            f"encode: stats {stats} for {n} float32 tensors")

    # Every payload decodes (tile two-pass) to its quantizer's codes and
    # reconstructs within eb_effective.
    base = Codec()
    quant = {}
    for (name, x), c in zip(tensors, cs):
        require(c.device.type == "cuda", f"encode: {name} left the card")
        codes, outlier, resid = ops.lorenzo_quantize(x, c.eb, c.radius)
        got = base.decode(c.stream, c.codebook, c.n_symbols)
        require(same(got, codes.reshape(-1)),
                f"encode: {name} decodes to other codes than its quantizer's")
        err = max_abs_err(base.decompress(c), x)
        require(err <= c.eb_effective,
                f"encode: {name} max|x - x'| = {err} > eb_effective "
                f"{c.eb_effective}")
        if name in xs or name == "page0":
            quant[name] = (codes, outlier, resid, err)
    torch.cuda.synchronize()

    # The lattice field: byte for byte the "ref" encode.
    xl = torch.from_numpy(make_lattice(seed)).cuda()
    cl_dev = Codec(CodecConfig(eb=LATTICE_EB, mode="abs",
                               encode_backend="cuda")).compress(xl)
    cl_ref = Codec(CodecConfig(eb=LATTICE_EB, mode="abs")).compress(xl)
    n_lat_out = int((cl_dev.outlier_pos >= 0).sum())
    require(n_lat_out > 0, "encode: the lattice field has no outlier")
    require(same_payload(cl_dev, cl_ref),
            "encode: the lattice field's payload differs from the ref "
            "encode")
    print(f"encode lattice: float32{list(LATTICE_SHAPE)}, eb 2**-10 abs, "
          f"{n_lat_out} outliers, payload byte-identical to the ref encode")

    # Each kernel against its plain version, at the inputs of the path.
    rows = {}
    for (name, x), c in zip(tensors, cs):
        if name not in quant:       # the fields and one KV page
            continue
        codes, outlier, resid, err = quant[name]
        two_eb = ops._two_eb_f32(c.eb)
        qargs = (x, two_eb, c.radius)
        qp = L.lorenzo_quantize_plain(*qargs)
        require(all(same(a, b) for a, b in zip((codes, outlier, resid), qp)),
                f"encode: {name} lorenzo_quantize differs from its plain "
                f"version")
        ref_codes = lorenzo.quantize_host(x, c.eb, c.radius)[0]
        n_vs_ref = int((ref_codes.to(torch.int32)
                        != codes.to(torch.int32)).sum())
        nbins = 2 * c.radius
        flat = codes.reshape(-1)
        hk = H.histogram(flat, nbins)
        hpl = H.histogram_plain(flat, nbins)
        require(same(hk, hpl), f"encode: {name} histogram differs from its "
                f"plain version")
        enc_code = torch.from_numpy(c.codebook.enc_code).cuda()
        enc_len = torch.from_numpy(c.codebook.enc_len).cuda()
        starts = ops.code_starts(flat, enc_len)
        n_units = c.stream.units.numel()
        pargs = (flat, starts, enc_code, enc_len, n_units)
        pk = E.pack_tiles(*pargs)
        ppl = E.pack_tiles_plain(*pargs)
        require(same(pk, ppl) and same(pk, c.stream.units),
                f"encode: {name} pack_tiles differs from its plain version "
                f"or from the payload")
        torch.cuda.synchronize()
        m = x.numel()
        ref_codec = Codec(CodecConfig())
        row = {
            "field": name, "shape": list(x.shape), "ratio": c.ratio,
            "bits_per_code": c.stream.total_bits / m,
            "n_outliers": int((c.outlier_pos >= 0).sum()),
            "codes_differing_from_ref_quantizer": n_vs_ref,
            "max_abs_err": err, "eb_effective": c.eb_effective,
            "compress_ref_ms": cuda_ms(lambda: ref_codec.compress(x), 2),
            "compress_cuda_ms": cuda_ms(lambda: codec.compress(x), 5),
            "lorenzo_quantize": {
                "ms": cuda_ms(lambda: L.lorenzo_quantize(*qargs), 20),
                "plain_ms": cuda_ms(lambda: L.lorenzo_quantize_plain(*qargs),
                                    3),
                "bound_ms": 11 * m / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max(max_abs_diff(a, b) for a, b in zip(
                    (codes, outlier, resid), qp))},
            "histogram": {
                "ms": cuda_ms(lambda: H.histogram(flat, nbins), 20),
                "plain_ms": cuda_ms(lambda: H.histogram_plain(flat, nbins),
                                    5),
                # one PyTorch call on the same bytes (codes < 2**15)
                "library_ms": cuda_ms(lambda: torch.bincount(
                    flat.view(torch.int16), minlength=nbins), 20),
                "bound_ms": (2 * m + 4 * nbins) / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max_abs_diff(hk, hpl)},
            "pack_tiles": {
                "ms": cuda_ms(lambda: E.pack_tiles(*pargs), 20),
                "plain_ms": cuda_ms(lambda: E.pack_tiles_plain(*pargs), 1),
                "bound_ms": (6 * m + 4 * n_units + 5 * enc_code.numel())
                / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max_abs_diff(pk, ppl)},
        }
        # Where compress_cuda_ms goes: its stages one at a time, on this
        # field's inputs (CUDA events around host and device work alike).
        def gather_outliers(mask=outlier.reshape(-1), r=resid.reshape(-1)):
            csum = torch.cumsum(mask, 0, dtype=torch.int32)
            return compressor._gather_outliers(
                csum, r, compressor._outlier_m_pad(int(csum[-1])))

        row["compress_cuda_stages_ms"] = {
            "range_and_max_abs": cuda_ms(lambda: (
                float(x.max() - x.min()), float(x.abs().max())), 5),
            "quantize": row["lorenzo_quantize"]["ms"],
            "outlier_gather": cuda_ms(gather_outliers, 5),
            "histogram": row["histogram"]["ms"],
            "encoder_plan": cuda_ms(lambda: hp.build_encoder_plan(
                hk, max_len=c.codebook.max_len,
                subseqs_per_seq=c.stream.subseqs_per_seq, backend="cuda",
                device=x.device), 5),
            "encode_bitpack": cuda_ms(lambda: ops.encode_bitpack(
                flat, enc_code, enc_len, c.stream.total_bits,
                c.stream.subseqs_per_seq), 5),
        }
        # The histogram's device time beside its wrapper's on every tensor
        # (a field's wrapper also fills its output with zeros).
        split = launch_split(lambda: H.histogram(flat, nbins))
        row["histogram"].update(device_ms=split["device_ms"],
                                host_ms=split["host_ms"])
        if name == "page0":
            # Where a page launch's time goes, host and device, and the
            # host time of the wrapper's geometry lookup alone.
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            key = (flat.data_ptr() % H.HIST_VEC_BYTES, flat.numel(),
                   flat.element_size(), nbins, sms)
            t0 = time.perf_counter()
            for _ in range(GEOMETRY_CALLS):
                H._histogram_geometry(*key)
            split["geometry_host_ms"] = (
                (time.perf_counter() - t0) * 1e3 / GEOMETRY_CALLS)
            print(f"page launch split histogram: {json.dumps(split)}")
            for kname, fn in (("lorenzo_quantize",
                               lambda: L.lorenzo_quantize(*qargs)),
                              ("pack_tiles", lambda: E.pack_tiles(*pargs))):
                split = launch_split(fn)
                row[kname].update(device_ms=split["device_ms"],
                                  host_ms=split["host_ms"])
                print(f"page launch split {kname}: {json.dumps(split)}")
        rows[name] = row

    # -- reconstruct phase: counts zeroed just before, read just after ------
    x = xs["hacc1d"]
    c = cs[list(xs).index("hacc1d")]
    resid = quant["hacc1d"][2]
    y, rcounts = run_path("reconstruct", RECONSTRUCT_KERNELS,
                          lambda: ops.lorenzo_reconstruct(resid, c.eb))
    require(rcounts["reconstruct1d"] == 1, f"reconstruct: {rcounts}")
    two_eb = ops._two_eb_f32(c.eb)
    rk = L.reconstruct1d(resid, two_eb)
    rp = L.reconstruct1d_plain(resid, two_eb)
    require(same(rk, rp) and same(rk, y),
            "reconstruct1d differs from its plain version")
    rerr = max_abs_err(y, x)
    bound = c.eb + float(np.spacing(np.float32(c.max_abs + c.eb)))
    require(rerr <= bound, f"reconstruct: max|x - x'| = {rerr} > {bound}")
    rows["hacc1d"]["reconstruct1d"] = {
        "ms": cuda_ms(lambda: L.reconstruct1d(resid, two_eb), 20),
        "device_ms": launch_split(
            lambda: L.reconstruct1d(resid, two_eb))["device_ms"],
        "plain_ms": cuda_ms(lambda: L.reconstruct1d_plain(resid, two_eb), 5),
        "bound_ms": 8 * resid.numel() / HBM_BYTES_PER_S * 1e3,
        # one PyTorch scan of the same residuals (the yardstick of rows 6
        # and 9; the port never calls it)
        "library_ms": cuda_ms(
            lambda: torch.cumsum(resid, 0, dtype=torch.int32), 20),
        "max_abs_err": max_abs_err(rk, rp), "roundtrip_max_abs_err": rerr}
    for row in rows.values():
        print(f"encode {json.dumps(row)}")
    summary = {"tensors": n, "launches": counts, "stats": stats,
               "compress_all_s": t_all, "reconstruct_launches": rcounts}
    print(f"encode path {json.dumps(summary)}")
    return {"fields": rows, "launches": counts,
            "reconstruct_launches": rcounts}


def run_chunked(results, rows, selfsync) -> dict:
    """Table V's baseline: cuSZ's chunked coder on each field's quant codes
    at ``CHUNK_SIZES`` symbols a chunk (``encode_chunked``, then
    ``decode_chunked`` on the card, its launch check with its plain version
    made to raise), the output against the plain version bit for bit and
    its first n codes against ``Codec.decode``'s, and the times: the
    kernel's ms and GB/s of codes, its stored bytes beside the gap stream's,
    and the speedup of each Table V decoder over it.  Prints one
    ``chunked`` row per field and returns ``{"fields": rows, "launches":
    ..., "kernel": the kernels-line entry (hacc1d, 16,384)}``."""
    import torch

    from repro_torch.core.huffman import decode as hd
    from repro_torch.core.huffman import encode as he
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import huffman_chunked as HC
    from repro_torch.kernels import huffman_decode as K

    inputs = {}
    for name, (codec, c, _, _, _) in results.items():
        codes = codec.decode(c.stream, c.codebook, c.n_symbols)
        luts = hp._as_luts(c.codebook, c.device)
        for chunk in CHUNK_SIZES:
            ch = he.encode_chunked(codes, c.codebook.enc_code,
                                   c.codebook.enc_len, chunk)
            inputs[name, chunk] = (codes, ch, (
                ch["units"], ch["chunk_bits"], ch["chunk_syms"],
                luts.dec_sym, luts.dec_len, luts.max_len, chunk))

    plain = HC.decode_chunked_plain

    def refuse(*args, **kwargs):
        raise RuntimeError("decode_chunked's plain version ran for a CUDA "
                           "tensor")

    def drive():
        return {key: hd.decode_chunked(*args)
                for key, (_, _, args) in inputs.items()}

    HC.decode_chunked_plain = refuse
    try:
        outs, counts = run_path("chunked", CHUNKED_KERNELS, drive)
    finally:
        HC.decode_chunked_plain = plain

    field_rows = {r["field"]: r for r in rows}
    out_rows, kernel = {}, None
    for name, (codec, c, _, _, _) in results.items():
        row = {"field": name, "n_codes": c.n_symbols,
               "gap_stream_bytes": -(-c.stream.total_bits // 8),
               "gap_array_bytes": c.stream.n_subseq}
        frow, srow = field_rows[name], selfsync["fields"][name]
        decoders = {"gap_tile": frow["decode_ms"],
                    "gap_padded": frow["decode_ms_padded"],
                    "gap_tuned": frow["decode_ms_tuned"],
                    "opt_selfsync": srow["opt_decode_ms"],
                    "ori_selfsync": srow["ori_decode_ms"]}
        row["decoders_ms"] = decoders
        for chunk in CHUNK_SIZES:
            codes, ch, args = inputs[name, chunk]
            got = outs[name, chunk]
            require(got.device.type == "cuda"
                    and same(got.reshape(-1)[:c.n_symbols], codes),
                    f"{name}: decode_chunked at {chunk} symbols a chunk "
                    f"differs from Codec.decode's codes")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain(*args)
            stop.record()
            torch.cuda.synchronize()
            require(same(got, want), f"{name}: decode_chunked at {chunk} "
                    f"symbols a chunk differs from its plain version")
            n_chunks, max_units = ch["units"].shape
            ms = cuda_ms(lambda: HC.decode_chunked(*args), 5)
            lut = 1 << args[5]
            entry = {
                "chunks": n_chunks, "max_units": max_units,
                "geometry": HC.decode_chunked_geometry(
                    n_chunks, lut, K.sm_count(0)),
                "width_ms": chunked_widths(args), "ms": ms,
                "plain_ms": start.elapsed_time(stop),
                "bound_ms": (4 * n_chunks * max_units + 8 * n_chunks
                             + 3 * (1 << args[5])
                             + 2 * n_chunks * chunk) / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max_abs_diff(got, want),
                "gbps": c.quant_code_bytes / (ms * 1e-3) / 1e9,
                "stored_bytes": ch["stored_bytes"],
                "stored_over_gap_stream": ch["stored_bytes"]
                / row["gap_stream_bytes"],
                "lut_in_smem": HC.decode_chunked_lut_in_smem(1 << args[5]),
                "speedup_over_chunked": {k: ms / v
                                         for k, v in decoders.items()}}
            row[f"chunk_{chunk}"] = entry
            if name == "hacc1d" and chunk == CHUNK_SIZES[0]:
                kernel = entry
        out_rows[name] = row
        print(f"chunked {json.dumps(row)}")
    del inputs, outs
    torch.cuda.empty_cache()
    kernel = {**kernel, "fields_ms": {
        f: r[f"chunk_{CHUNK_SIZES[0]}"]["ms"] for f, r in out_rows.items()}}
    return {"fields": out_rows, "launches": counts, "kernel": kernel}


def table_v(chunked) -> dict:
    """Table V's speedups over the chunked baseline, a field and chunk
    size: ``{field: {chunk: {decoder: speedup}}}``."""
    return {name: {chunk: row[f"chunk_{chunk}"]["speedup_over_chunked"]
                   for chunk in CHUNK_SIZES}
            for name, row in chunked["fields"].items()}


def store_summary(store, pager) -> dict:
    """The store's and the pager's times, in one line."""
    return {"archive_bytes": store["archive_bytes"],
            "write_ms": store["write_s"] * 1e3,
            "cold_read_ms": store["cold_read_s"] * 1e3,
            "warm_read_ms": store["warm_read_s"] * 1e3,
            "decompress_tree_ms": store["decompress_tree_ms"],
            "offload_ms": pager["offload_ms"],
            "page_in_ms": pager["page_in_ms"],
            "page_in_warm_ms": pager["page_in_warm_ms"],
            "page_stage_ms": pager["stage_ms"],
            "page_decode_staged_ms": pager["decode_staged_ms"],
            "page_compress_ms": pager["compress_ms"],
            "page_ratio": pager["ratio"]}


def chunked_widths(args) -> dict:
    """``decode_chunked``'s ms at each block width it takes
    (``huffman_chunked.CHUNK_WIDTHS``) on the same inputs, the geometry's
    choice replaced for the reading; the output checked against the
    chosen width's each time."""
    from repro_torch.kernels import huffman_chunked as HC

    want = HC.decode_chunked(*args)
    geometry = HC.decode_chunked_geometry
    out = {}
    try:
        for threads in HC.CHUNK_WIDTHS:
            def forced(n_chunks, lut, sm, threads=threads):
                return -(-n_chunks // threads), threads, geometry(
                    n_chunks, lut, sm)[2]

            HC.decode_chunked_geometry = forced
            require(same(HC.decode_chunked(*args), want),
                    f"decode_chunked at {threads} threads a block differs")
            out[threads] = cuda_ms(lambda: HC.decode_chunked(*args), 3)
    finally:
        HC.decode_chunked_geometry = geometry
    return out


def _named_leaves(tree, prefix=""):
    """``(path, leaf)`` of every leaf of a dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def run_store(seed: int, xs) -> dict:
    """Trees and the store: a dict tree of the three fields, the
    ``N_PAGES`` KV pages, an int32 leaf, a ``None`` leaf and a nested list
    through ``compress_tree`` and ``decompress_tree`` (exactly one
    ``decompress_batch`` call, its launch check; bit for bit that call's
    values, every other leaf the same object), then the same compressed
    leaves through ``ArchiveWriter`` and a cold and a warm ``iter_decode``
    on the card (launch checks; the values bit for bit; the warm read
    builds zero plans and hits the codebook cache).  Prints and returns one
    ``store`` row."""
    import shutil

    import torch

    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.sz.compressor import Compressed
    from repro_torch.store import Archive, ArchiveWriter

    pages = [torch.from_numpy(p).cuda() for p in make_pages(seed)]
    step = torch.tensor([seed, 7], dtype=torch.int32, device="cuda")
    tree = {"fields": dict(xs), "pages": pages, "step": step, "none": None,
            "nested": [[xs["hacc1d"][:4096], None], 3]}
    codec = Codec(CodecConfig())
    t0 = time.perf_counter()
    ctree = codec.compress_tree(tree)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    named = list(_named_leaves(ctree))
    cs = [(n, c) for n, c in named if isinstance(c, Compressed)]
    require(len(cs) == len(xs) + N_PAGES + 1,
            f"tree: {len(cs)} compressed leaves")
    calls = []
    batch = codec.decompress_batch

    def counted(items, **kwargs):
        calls.append(len(items))
        return batch(items, **kwargs)

    def drive():
        codec.decompress_batch = counted
        try:
            return codec.decompress_tree(ctree)
        finally:
            del codec.decompress_batch

    back, tree_counts = run_path("tree", TREE_KERNELS, drive)
    require(calls == [len(cs)], f"tree: decompress_batch calls {calls}, "
            f"not one of {len(cs)} leaves")
    want = dict(zip([n for n, _ in cs],
                    codec.decompress_batch([c for _, c in cs])))
    for (name, leaf), (_, orig) in zip(_named_leaves(back),
                                       _named_leaves(tree)):
        if name in want:
            require(same(leaf, want[name]), f"tree: {name} differs from "
                    f"decompress_batch")
        else:
            require(leaf is orig, f"tree: leaf {name} was not returned "
                    f"untouched")
    tree_ms = cuda_ms(lambda: codec.decompress_tree(ctree), 3)

    directory = os.path.join(ROOT, "build", "chip_smoke_store")
    shutil.rmtree(directory, ignore_errors=True)
    path = os.path.join(directory, "tree.szt")
    t0 = time.perf_counter()
    with ArchiveWriter(path) as w:
        for name, c in cs:
            w.add(name, c)
    write_s = time.perf_counter() - t0
    reader = Codec(CodecConfig(), plan_cache=PlanCache())

    def read():
        with Archive(path, codec=reader) as ar:
            out = ar.read_all()
        torch.cuda.synchronize()
        return out

    reader.reset_stats()
    t0 = time.perf_counter()
    cold, cold_counts = run_path("store read", STORE_READ_KERNELS, read)
    cold_s = time.perf_counter() - t0
    cold_stats = dict(reader.stats)
    reader.reset_stats()
    t0 = time.perf_counter()
    warm, warm_counts = run_path("store warm read", STORE_WARM_KERNELS, read)
    warm_s = time.perf_counter() - t0
    warm_stats = dict(reader.stats)
    for name, _ in cs:
        require(same(cold[name], want[name]) and same(warm[name],
                                                      want[name]),
                f"store: {name} read back differs from decompress_batch")
    require(cold_stats["plan_builds"] == len(cs),
            f"store: cold read stats {cold_stats}")
    require(warm_stats["plan_builds"] == 0 and warm_stats["lut_hits"] > 0
            and warm_stats["lut_misses"] == 0,
            f"store: warm read stats {warm_stats}")
    row = {"leaves": len(named), "compressed_leaves": len(cs),
           "compress_tree_s": compress_s,
           "decompress_tree_ms": tree_ms,
           "decompress_batch_calls": calls, "tree_launches": tree_counts,
           "archive_bytes": os.path.getsize(path), "write_s": write_s,
           "cold_read_s": cold_s, "warm_read_s": warm_s,
           "cold_stats": cold_stats, "warm_stats": warm_stats,
           "read_launches": cold_counts, "warm_read_launches": warm_counts}
    shutil.rmtree(directory, ignore_errors=True)
    print(f"store {json.dumps(row)}")
    return row


def prefill_cache(params, tokens, cfg):
    """The prefill forward (``steps.make_prefill_step``) with each layer's
    keys and values kept as ``blockwise_attn`` receives them: the decode
    cache {"k", "v"} (L, B, S, Hkv, Dh) in the compute type that the
    prompt's step decode would have written."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import steps as St

    keys, values = [], []
    attn = A.blockwise_attn

    def keep(q, k, v, **kwargs):
        keys.append(k)
        values.append(v)
        return attn(q, k, v, **kwargs)

    A.blockwise_attn = keep
    try:
        St.make_prefill_step(cfg)(params, tokens)
    finally:
        A.blockwise_attn = attn
    return {"k": torch.stack(keys), "v": torch.stack(values)}


def run_pager(seed: int) -> dict:
    """The KV pager at full width: qwen3-0.6b prefilled at B 4 x 1024 (its
    keys and values kept as the decode cache), tokens ``PAGE_SPAN`` of
    every pageable cache tensor offloaded through a "cuda"-encode codec and
    paged back in (one launch check over both), every paged value within
    the codec's bound of the original, the span zeroed in between, and a
    second page-in that builds zero plans.  Prints and returns one
    ``pager`` row."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import configs
    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.models import transformer as T
    from repro_torch.store import KVPager

    cfg = configs.get_config("qwen3-0.6b")
    params = T.init_model(seed, cfg, "cuda")
    gen = T.generator(seed + 1, "cuda")
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN),
                           generator=gen, device="cuda")
    cache = prefill_cache(params, tokens, cfg)
    del params
    lo, hi = PAGE_SPAN
    span = (slice(None), slice(None), slice(lo, hi))
    orig = {k: t[span].clone() for k, t in cache.items()}
    directory = os.path.join(ROOT, "build", "chip_smoke_pager")
    shutil.rmtree(directory, ignore_errors=True)
    codec = Codec(CodecConfig(encode_backend="cuda"), plan_cache=PlanCache())
    pager = KVPager(directory, codec=codec)
    state = {}

    def drive():
        t0 = time.perf_counter()
        _, bid = pager.offload(cache, lo, hi)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state["zeroed"] = all(not bool(t[span].any()) for t in cache.values())
        pager.page_in(cache, bid)
        torch.cuda.synchronize()
        state.update(bid=bid, offload_s=t1 - t0,
                     page_in_s=time.perf_counter() - t1)

    _, counts = run_path("pager", PAGER_KERNELS, drive)
    bid = state["bid"]
    require(state["zeroed"], "pager: the offloaded span was not zeroed")
    require(pager.block_meta(bid)["names"] == ["k", "v"],
            f"pager: paged {pager.block_meta(bid)['names']}")
    t0 = time.perf_counter()
    staged = pager.stage(bid)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pager.decode_staged([staged])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in orig.values():
        codec.compress(t.to(torch.float32))
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    errs = {}
    for name, c in zip(staged.names, staged.cs):
        bound = dataclasses.replace(c, dtype=cache[name].dtype).eb_effective
        err = max_abs_err(cache[name][span], orig[name])
        require(err <= bound, f"pager: {name} paged back with max|x - x'| "
                f"{err} > {bound}")
        errs[name] = {"max_abs_err": err, "bound": bound}
    codec.reset_stats()
    t0 = time.perf_counter()
    pager.page_in(cache, bid)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    require(codec.stats["plan_builds"] == 0,
            f"pager: a second page-in built {codec.stats['plan_builds']} "
            f"plans")
    row = {"arch": cfg.name, "cache": {k: [str(t.dtype), list(t.shape)]
                                       for k, t in cache.items()},
           "span": [lo, hi], "values": sum(t.numel() for t in orig.values()),
           "launches": counts, "offload_ms": state["offload_s"] * 1e3,
           "page_in_ms": state["page_in_s"] * 1e3,
           "page_in_warm_ms": warm_s * 1e3,
           # the halves of a warm page-in, and the offload's compress alone
           "stage_ms": stage_s * 1e3, "decode_staged_ms": decode_s * 1e3,
           "compress_ms": compress_s * 1e3, "ratio": pager.ratio,
           "stats": pager.stats, "errors": errs}
    pager.drop(bid)
    shutil.rmtree(directory, ignore_errors=True)
    del cache, orig
    torch.cuda.empty_cache()
    print(f"pager {json.dumps(row)}")
    return row


def model_kernel_bound(kname: str, args, out) -> tuple:
    """``(bound_ms, bound_by)`` of one launch at these inputs: the larger of
    the bytes (each input read once, each output written once) at the HBM
    rate and the operations at the card's peak for their type.  flash:
    2 (D + Dv) FLOP for each (query, key) pair the causal mask keeps, at the
    bf16 tensor-core peak; gla: 7 float32 FLOP a state element a step
    (k v, u (k v) + S, r (...) summed, w S + k v), at the float32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None)
    nbytes += sum(t.numel() * t.element_size() for t in out)
    if kname == "flash_attention":
        q, k, v = args
        bh, sq, d = q.shape
        skv, dv = k.shape[1], v.shape[2]
        pairs = sum(min(i + 1, skv) for i in range(sq))
        ops_s = 2 * bh * pairs * (d + dv) / PEAK_FLOPS[_dtype_name(q)]
    else:
        r, _, v = args[:3]
        bh, s, dk = r.shape
        ops_s = 7 * bh * s * dk * v.shape[2] / PEAK_FLOPS[_dtype_name(r)]
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s
                                       else "operations")


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def layer0_kernel_inputs(cfg, params, tokens):
    """The inputs layer 0 of the prefill forward gives its kernel: the
    attention's (q, k, v) for the dense family, the recurrence's (r, k, v,
    w, u, state) for rwkv, made by the port's own functions."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv as R

    with torch.inference_mode():
        x = params["embed"][tokens].to(cfg.cdt)
        lp = params["layers"][0]
        xn = L.rms_norm(x, lp["ln1"])
        if cfg.family == "dense":
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
            return A.attn_kernel_inputs(*A._project_qkv(
                xn, lp["attn"], cfg, positions))
        xs = R._token_shift(xn, torch.zeros_like(xn[:, 0]))
        r, k, v, _, w = R._time_mix_proj(xn, xs, lp["tmix"], cfg)
        return (*R.recurrence_inputs(r, k, v, w, lp["tmix"], cfg), None)


def check_model_kernel(kname, args, stage: str) -> float:
    """One kernel launch against its plain version on the same inputs, at
    the tolerance stated: flash in bf16 within one bf16 ulp of the output's
    scale (the kernel rounds p to bf16 for its tensor-core P V product, a
    term moving by at most 2**-9 of |v|, and both round the output once),
    in float32 within 2e-5;
    gla (float32) within 1e-4 of the output's scale (sums over dk in another
    order).  Returns the largest absolute difference."""
    import torch

    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import rwkv_gla as GLA
    from repro_torch.testing import kernel_cases as KC

    if kname == "flash_attention":
        q, k, v, causal, scale = args
        got = [FA.flash_attention(q, k, v, causal=causal, scale=scale)]
        want = [FA.flash_attention_plain(q, k, v, causal=causal,
                                         scale=scale)]
        if q.dtype == torch.bfloat16:
            tol = KC.bf16_ulp(float(want[0].float().abs().max()))
        else:
            tol = 2e-5 * max(1.0, float(want[0].abs().max()))
    else:
        got = list(GLA.gla_time_mix(*args))
        want = list(GLA.gla_time_mix_plain(*args))
        tol = 1e-4 * max(1.0, max(float(w.abs().max()) for w in want))
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(all(bool(torch.isfinite(a).all()) for a in got),
            f"{stage}: {kname} output is not finite")
    require(err <= tol, f"{stage}: {kname} differs from its plain version "
            f"by {err} > {tol}")
    return err


def run_model(seed: int) -> dict:
    """The model phase, for qwen3-0.6b and rwkv6-3b at full width with
    weights from ``seed`` on the card: the prefill forward (its launch
    check), the kernel against its plain version at layer 0's inputs and on
    the random cases of ``repro_torch.testing.kernel_cases``, serve.main at
    the reference's defaults (its launch check), and step decode against
    the forward in float32.  Prints one ``model`` row per config and
    returns ``{"rows": ..., "kernels": {name: entry}}``."""
    import contextlib
    import dataclasses
    import io
    import re

    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import rwkv_gla as GLA
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.testing import kernel_cases as KC

    # Full float32 matmuls (the card's default, stated): the float32
    # forward-against-decode gate and the plain versions rely on it.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- random-input cases, small and ragged -----------------------------
    case_errs = {"flash_attention": 0.0, "gla_time_mix": 0.0}
    for case in KC.FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = KC.flash_inputs(case, dtype, "cuda", seed)
            case_errs["flash_attention"] = max(
                case_errs["flash_attention"], check_model_kernel(
                    "flash_attention", (q, k, v, case[7], case[8]),
                    f"flash case {case[0]} {dtype}"))
    for case in KC.GLA_CASES:
        case_errs["gla_time_mix"] = max(
            case_errs["gla_time_mix"], check_model_kernel(
                "gla_time_mix", KC.gla_inputs(case, "cuda", seed),
                f"gla case {case[0]}"))
    print(f"model kernel random cases: {len(KC.FLASH_CASES) * 2} flash, "
          f"{len(KC.GLA_CASES)} gla, max|kernel - plain| "
          f"{json.dumps(case_errs)}")

    rows, kernels = {}, {}
    for arch in MODEL_ARCHS:
        cfg = configs.get_config(arch)
        kname = ("flash_attention" if cfg.family == "dense"
                 else "gla_time_mix")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_model(seed, cfg, "cuda")
        torch.cuda.synchronize()
        row = {"arch": arch, "family": cfg.family,
               "init_s": time.perf_counter() - t0,
               "params": sum(t.numel() for t in _leaves(params)),
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in _leaves(params))}
        gen = T.generator(seed + 1, "cuda")
        tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN),
                               generator=gen, device="cuda")

        # prefill forward: counts zeroed just before, read just after
        prefill = St.make_prefill_step(cfg)
        logits, counts = run_path(f"{arch} prefill", (kname,),
                                  lambda: prefill(params, tokens))
        require(counts[kname] == cfg.n_layers,
                f"{arch}: {counts[kname]} {kname} launches in the prefill, "
                f"not one a layer ({cfg.n_layers})")
        require(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN,
                                        cfg.vocab)
                and logits.dtype == torch.bfloat16
                and bool(torch.isfinite(logits).all()),
                f"{arch}: prefill logits {logits.dtype}"
                f"{list(logits.shape)}")
        del logits
        row["prefill_launches"] = counts[kname]
        row["prefill_ms"] = cuda_ms(lambda: prefill(params, tokens), 3)
        row["prefill_tok_per_s"] = PREFILL_BATCH * PREFILL_LEN / (
            row["prefill_ms"] * 1e-3)
        row["prefill_profile"] = profile_breakdown(
            lambda: prefill(params, tokens))

        # the kernel against its plain version at layer 0's inputs
        args = layer0_kernel_inputs(cfg, params, tokens)
        if kname == "flash_attention":
            q, k, v = args
            err = check_model_kernel(kname, (q, k, v, True, 1.0),
                                     f"{arch} layer 0")
            out = FA.flash_attention(q, k, v, causal=True, scale=1.0)
            b, hq, hkv = PREFILL_BATCH, cfg.n_heads, cfg.n_kv_heads
            q4, k4, v4 = (t.view(b, h, PREFILL_LEN, t.shape[-1])
                          for t, h in ((q, hq), (k, hkv), (v, hkv)))

            def library():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, scale=1.0, enable_gqa=True)

            lib_err = max_abs_err(library().reshape(out.shape), out)
            entry = {
                "ms": cuda_ms(lambda: FA.flash_attention(
                    q, k, v, causal=True, scale=1.0), 20),
                "plain_ms": cuda_ms(lambda: FA.flash_attention_plain(
                    q, k, v, causal=True, scale=1.0), 3),
                "library_ms": cuda_ms(library, 20),
                "library_max_abs_err": lib_err}
            outs = (out,)
            kargs = (q, k, v)
        else:
            err = check_model_kernel(kname, args, f"{arch} layer 0")
            outs = GLA.gla_time_mix(*args)
            entry = {
                "ms": cuda_ms(lambda: GLA.gla_time_mix(*args), 20),
                "plain_ms": cuda_ms(lambda: GLA.gla_time_mix_plain(*args),
                                    1),
                "library_ms": None}
            kargs = args
            # serve's decode step: S 1 with the state in (layer 0's first
            # step after the prefill's state), as each of serve.main's
            # 2,048 launches
            dargs = (*(t[:, :1].contiguous() for t in args[:4]), args[4],
                     outs[1])
            err = max(err, check_model_kernel(kname, dargs,
                                              f"{arch} decode step"))
            dbound, _ = model_kernel_bound(kname, dargs,
                                           GLA.gla_time_mix(*dargs))
            n_dec = 200
            entry.update({
                "decode_shape": [list(t.shape) for t in dargs],
                # back to back through the wrapper: bound by its host cost
                "decode_ms": cuda_ms(lambda: GLA.gla_time_mix(*dargs),
                                     n_dec),
                # the kernel alone, from the profiler's device times
                "decode_device_ms": profile_breakdown(lambda: [
                    GLA.gla_time_mix(*dargs) for _ in range(n_dec)])[
                        "device_ms"] / n_dec,
                "decode_bound_ms": dbound})
            del dargs
        entry["bound_ms"], entry["bound_by"] = model_kernel_bound(
            kname, kargs, outs)
        entry["max_abs_err"] = max(err, case_errs[kname])
        entry["shape"] = [list(t.shape) for t in kargs if t is not None]
        entry["dtype"] = _dtype_name(kargs[0])
        entry["launches"] = counts[kname]
        del args, kargs, outs
        if kname == "flash_attention":
            del q, k, v, q4, k4, v4, out

        # step decode against the forward, float32, B 2, 256 tokens
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        toks = torch.randint(0, cfg.vocab, (CONSIST_BATCH, CONSIST_LEN),
                             generator=gen, device="cuda")
        full = St.make_prefill_step(cfg32)(params, toks)
        cache = D.init_cache(cfg32, CONSIST_BATCH, CONSIST_LEN, "cuda")
        step = St.make_serve_step(cfg32)
        t0 = time.perf_counter()
        steps = []
        for t in range(CONSIST_LEN):
            lg, cache = step(params, toks[:, t:t + 1], cache, t)
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
        row["decode_f32_steps_s"] = time.perf_counter() - t0
        # one bf16 serve step at the serve phase's shape (B 4, a 64-slot
        # cache), as serve.main runs it
        scache = D.init_cache(cfg, 4, 64, "cuda")
        stok = toks[:, :1].repeat(2, 1)
        row["serve_step_profile"] = profile_breakdown(
            lambda: St.make_serve_step(cfg)(params, stok, scache, 40))
        del scache
        stepped = torch.stack(steps, 1)
        diff = float((stepped - full).abs().max())
        top2 = full.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > DECODE_F32_TOL
        agree = stepped.argmax(-1) == full.argmax(-1)
        row["decode_vs_forward_f32"] = {
            "max_abs_diff": diff, "tol": DECODE_F32_TOL,
            "logit_scale": float(full.abs().max()),
            "positions": int(clear.numel()),
            "clear_top2": int(clear.sum()),
            "argmax_agree": int(agree.sum())}
        require(diff <= DECODE_F32_TOL,
                f"{arch}: step decode differs from the forward by {diff} > "
                f"{DECODE_F32_TOL} (float32)")
        require(bool(agree[clear].all()),
                f"{arch}: step decode's argmax differs from the forward's "
                f"where the top-2 gap exceeds {DECODE_F32_TOL}")
        del full, stepped, steps, cache, lg, params
        torch.cuda.empty_cache()

        # serve.main at the reference's defaults, counts zeroed just
        # before, read just after
        argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32",
                "--gen-len", "32", "--seed", str(seed)]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            served, scounts = run_path(
                f"{arch} serve", (kname,) if cfg.family == "rwkv" else (),
                lambda: serve.main(argv))
        print(printed.getvalue(), end="")
        want = (32 + 32) * cfg.n_layers if cfg.family == "rwkv" else 0
        require(scounts[kname] == want,
                f"{arch}: {scounts[kname]} {kname} launches in serve, not "
                f"{want}")
        require(served["tokens"].shape == (4, 33)
                and ((0 <= served["tokens"])
                     & (served["tokens"] < cfg.vocab)).all(),
                f"{arch}: serve tokens {served['tokens'].shape}")
        m = re.search(r"prefill \d+ toks in ([\d.]+)s; generated (\d+) "
                      r"tokens in ([\d.]+)s \(([\d.]+) tok/s\)",
                      printed.getvalue())
        require(m is not None, f"{arch}: serve printed no summary")
        row["serve"] = {"prefill_32_steps_s": float(m.group(1)),
                        "generated": int(m.group(2)),
                        "gen_s": float(m.group(3)),
                        "tok_per_s": float(m.group(4)),
                        "launches": scounts[kname]}
        entry["serve_launches"] = scounts[kname]
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del served
        torch.cuda.empty_cache()
        rows[arch] = row
        kernels[kname] = entry
        print(f"model {json.dumps(row)}")
        print(f"model kernel {kname} {json.dumps(entry)}")
    return {"rows": rows, "kernels": kernels}


def profile_breakdown(fn, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA): its wall
    time (host clock, synchronized), the device time summed over the kernels
    it launched, their count, the device's idle share of the wall time, and
    the ``top`` kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    device = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall, "device_ms": device,
            "device_kernels": len(kernels),
            "idle_share": max(0.0, 1 - device / wall),
            "top": [[name[:60], ms, n] for name, (ms, n) in ranked]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_kernels(seed: int, other: bool = False) -> dict:
    """Times of the kernels that ``--ab`` compares across source trees,
    through the wrappers of the ``repro_torch`` on the path, each checked
    against its plain version first, at the smoke run's inputs:
    ``count_subseq`` and ``decode_padded`` on the three fields; on each
    field its fused kernel and its epilogue (``decode_tiles_fused`` and
    ``dequant_reconstruct`` on hacc1d, ``decode_tiles_fused_nd`` and
    ``dequant_reconstruct_nd`` on isabel3d and cesm2d) and the fused and
    padded fused ``decompress`` (cached plan) that run them, and each
    field's outlier count; ``dequant_reconstruct`` on hacc1d also on the
    device alone (``launch_split``); ``decode_tiles_fused`` and
    ``dequant_reconstruct`` (wrapper and device) on hacc1d compressed at
    radius 4 and 2 (many outliers); on
    isabel3d ``decode_tiles`` at the default tile and at its most populous
    tuned class's tile, beside its decode-work yardstick (``count_subseq``
    on the same windows), and ``selfsync_intra`` (zero heads with
    ``early_exit``, chained heads with and without); ``count_subseq``,
    ``decode_padded`` and ``selfsync_intra`` through the same table widened
    to a ``2**LONG_MAX_LEN``-entry LUT (the device-memory variants; None
    for an ``other`` tree that refuses the table) beside their
    shared-memory times on the same windows; ``decode_tiles`` at the
    batch's merged-LUT dispatch (the fields and the KV pages), and the
    batch phase's ``decompress_batch`` and one ``decompress`` a tensor over
    the same tensors (cached plans); and on isabel3d the paths that run
    them: the gap decode (phases 1-4), the plan, the tile two-pass and
    padded ``decompress`` (cached plan), the self-sync plan with and
    without ``early_exit``, and the ori self-sync decode; then the write
    path (``time_write_path``)."""
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import _build
    from repro_torch.kernels import huffman_decode as K
    from repro_torch.kernels import huffman_selfsync as S
    from repro_torch.kernels import ops

    _build.build(["count_subseq", "decode_tiles", "decode_padded",
                  "selfsync_intra", "decode_tiles_fused",
                  "decode_tiles_fused_nd", "dequant_reconstruct",
                  "dequant_reconstruct_nd", "lorenzo_quantize", "histogram",
                  "pack_tiles"])
    out = {}
    fields = {}
    raw = make_fields(seed)
    for name, x in raw.items():
        codec = Codec(CodecConfig())
        fields[name] = (codec, codec.compress(torch.from_numpy(x).cuda()))
    base = Codec()
    cs = [c for _, c in fields.values()]
    cs += [base.compress(torch.from_numpy(p).cuda()) for p in make_pages(seed)]
    plans = [base.plan_for(c) for c in cs]
    # The batch phase's two ways over the same tensors (cached plans) come
    # first: they are host-bound, and the kernels timed below would leave
    # each tree's process in a different state (allocations, caches).
    out["batch_decompress_batch_cached_plan_ms"] = cuda_ms(
        lambda: base.decompress_batch(cs), 5)
    out["batch_decompress_each_cached_plan_ms"] = cuda_ms(
        lambda: [base.decompress(c) for c in cs], 3)
    for name, (codec, c) in fields.items():
        fcodec = Codec(CodecConfig(fused=True))
        pfcodec = Codec(CodecConfig(strategy="padded", fused=True))
        fkernel, fplain, fargs = fused_inputs(fcodec, c)
        require(same(fkernel(*fargs), fplain(*fargs)),
                f"{name}: {fkernel.__name__} differs from its plain "
                f"version")
        out[f"{fkernel.__name__}_{name}_ms"] = cuda_ms(
            lambda: fkernel(*fargs), 20)
        ekernel, eplain, eargs = ops.padded_epilogue_inputs(
            codec.decode(c.stream, c.codebook, c.n_symbols), c.n_symbols,
            c.outlier_pos, c.outlier_val, c.eb, c.radius, c.shape,
            c.dtype)
        require(same(ekernel(*eargs), eplain(*eargs)),
                f"{name}: {ekernel.__name__} differs from its plain "
                f"version")
        out[f"{ekernel.__name__}_{name}_ms"] = cuda_ms(
            lambda: ekernel(*eargs), 20)
        if name == "hacc1d":
            split = launch_split(lambda: ekernel(*eargs))
            out[f"{ekernel.__name__}_{name}_device_ms"] = split["device_ms"]
            out[f"{ekernel.__name__}_{name}_host_ms"] = split["host_ms"]
        out[f"decompress_fused_cached_plan_{name}_ms"] = cuda_ms(
            lambda: fcodec.decompress(c), 10)
        out[f"decompress_padded_fused_cached_plan_{name}_ms"] = cuda_ms(
            lambda: pfcodec.decompress(c), 10)
        out[f"outliers_{name}"] = int((c.outlier_pos >= 0).sum())
        if name == "hacc1d":
            # Many outliers: radius 4 and 2 leave a small codebook and make
            # a large share of hacc1d's codes outliers.
            for radius in (4, 2):
                rcodec = Codec(CodecConfig(radius=radius, fused=True))
                rc = rcodec.compress(torch.from_numpy(raw[name]).cuda())
                rkernel, rplain, rargs = fused_inputs(rcodec, rc)
                require(same(rkernel(*rargs), rplain(*rargs)),
                        f"hacc1d radius {radius}: {rkernel.__name__} "
                        f"differs from its plain version")
                out[f"outliers_hacc1d_radius{radius}"] = int(
                    (rc.outlier_pos >= 0).sum())
                out[f"{rkernel.__name__}_hacc1d_radius{radius}_ms"] = \
                    cuda_ms(lambda: rkernel(*rargs), 20)
                # The padded path's epilogue on the same stream.
                pkernel, pplain, pargs = ops.padded_epilogue_inputs(
                    rcodec.decode(rc.stream, rc.codebook, rc.n_symbols),
                    rc.n_symbols, rc.outlier_pos, rc.outlier_val, rc.eb,
                    rc.radius, rc.shape, rc.dtype)
                require(same(pkernel(*pargs), pplain(*pargs)),
                        f"hacc1d radius {radius}: {pkernel.__name__} "
                        f"differs from its plain version")
                split = launch_split(lambda: pkernel(*pargs))
                key = f"{pkernel.__name__}_hacc1d_radius{radius}"
                out[f"{key}_ms"] = split["wrapper_ms"]
                out[f"{key}_device_ms"] = split["device_ms"]
        count_args, tile_args = kernel_inputs(codec, c)
        require(all(same(a, b) for a, b in zip(
            K.count_subseq(*count_args), K.count_subseq_plain(*count_args))),
            f"{name}: count_subseq differs from its plain version")
        out[f"count_subseq_{name}_ms"] = cuda_ms(
            lambda: K.count_subseq(*count_args), 20)
        require(all(same(a, b) for a, b in zip(
            K.decode_padded(*count_args), K.decode_padded_plain(*count_args))),
            f"{name}: decode_padded differs from its plain version")
        out[f"decode_padded_{name}_ms"] = cuda_ms(
            lambda: K.decode_padded(*count_args), 20)
        if name != "isabel3d":
            continue
        tile, class_args = class_tile_args(codec, c)
        for key, args in (("decode_tiles", tile_args),
                          ("decode_tiles_class_tile", class_args)):
            require(same(K.decode_tiles(*args), K.decode_tiles_plain(*args)),
                    f"{name}: {key} differs from its plain version")
            out[f"{key}_ms"] = cuda_ms(lambda: K.decode_tiles(*args), 20)
        out["class_tile"] = tile
        out["decode_work_ms"] = out["count_subseq_isabel3d_ms"]
        out["long_codes"] = long_code_kernels(codec, c, refusal_ok=other)
        padded = Codec(CodecConfig(strategy="padded"))
        ori = Codec(CodecConfig(method="selfsync", strategy="padded"))
        out.update({
            "decode_ms": cuda_ms(lambda: codec.decode(
                c.stream, c.codebook, c.n_symbols), 10),
            "plan_ms": cuda_ms(lambda: codec.build_plan(
                c.stream, c.codebook), 10),
            "decompress_cached_plan_ms": cuda_ms(
                lambda: codec.decompress(c), 10),
            "decompress_padded_cached_plan_ms": cuda_ms(
                lambda: padded.decompress(c), 10),
            "selfsync_plan_ms": cuda_ms(lambda: hp.build_plan(
                c.stream, c.codebook, method="selfsync", backend="cuda"), 10),
            "selfsync_plan_no_early_exit_ms": cuda_ms(lambda: hp.build_plan(
                c.stream, c.codebook, method="selfsync", backend="cuda",
                early_exit=False), 5),
            "ori_decode_ms": cuda_ms(lambda: ori.decode(
                c.stream, c.codebook, c.n_symbols, early_exit=False), 5)})
        zero, chained = selfsync_kernel_args(c)
        for key, args, ee in (("", zero, True),
                              ("_chained_heads", chained, True),
                              ("_no_early_exit", chained, False)):
            require(all(same(a, b) for a, b in zip(
                S.selfsync_intra(*args, ee),
                S.selfsync_intra_plain(*args, ee))),
                f"{name}: selfsync_intra differs from its plain version")
            out[f"selfsync_intra{key}_ms"] = cuda_ms(
                lambda: S.selfsync_intra(*args, ee), 20)
    targs, _, _ = merged_lut_args(cs, plans)
    require(same(K.decode_tiles(*targs), K.decode_tiles_plain(*targs)),
            "batch: merged-LUT decode_tiles differs from its plain version")
    out["decode_tiles_merged_lut_ms"] = cuda_ms(
        lambda: K.decode_tiles(*targs), 20)
    out.update(time_write_path(seed))
    return out


def time_write_path(seed: int) -> dict:
    """``--ab``'s write-path rows: ``lorenzo_quantize``, ``histogram`` and
    ``pack_tiles`` on the three fields and one KV page, each checked against
    its plain version first and called at the tree's own defaults,
    each timed through the wrapper and on the device alone
    (``launch_split``), the "cuda" ``compress`` of isabel3d and of the
    page, and ``reconstruct1d`` on hacc1d's residuals (wrapper and device)
    beside ``torch.cumsum`` of the same residuals (device), the library
    yardstick of rows 6 and 9."""
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels import huffman_encode as E
    from repro_torch.kernels import lorenzo as L
    from repro_torch.kernels import ops

    out = {}
    tensors = dict(make_fields(seed), page0=make_pages(seed)[0])
    for name, xn in tensors.items():
        x = torch.from_numpy(xn).cuda()
        codec = Codec(CodecConfig(encode_backend="cuda"))
        c = codec.compress(x)
        qargs = (x, ops._two_eb_f32(c.eb), c.radius)
        codes = L.lorenzo_quantize(*qargs)
        require(all(same(a, b) for a, b in zip(
            codes, L.lorenzo_quantize_plain(*qargs))),
            f"{name}: lorenzo_quantize differs from its plain version")
        flat = codes[0].reshape(-1)
        enc_code = torch.from_numpy(c.codebook.enc_code).cuda()
        enc_len = torch.from_numpy(c.codebook.enc_len).cuda()
        pargs = (flat, ops.code_starts(flat, enc_len), enc_code, enc_len,
                 c.stream.units.numel())
        units = E.pack_tiles(*pargs)
        require(same(units, E.pack_tiles_plain(*pargs))
                and same(units, c.stream.units),
                f"{name}: pack_tiles differs from its plain version")
        nbins = 2 * c.radius
        require(same(H.histogram(flat, nbins), H.histogram_plain(flat, nbins)),
                f"{name}: histogram differs from its plain version")
        for kname, fn in (("lorenzo_quantize",
                           lambda: L.lorenzo_quantize(*qargs)),
                          ("histogram", lambda: H.histogram(flat, nbins)),
                          ("pack_tiles", lambda: E.pack_tiles(*pargs))):
            split = launch_split(fn)
            out[f"{kname}_{name}_ms"] = split["wrapper_ms"]
            out[f"{kname}_{name}_device_ms"] = split["device_ms"]
            out[f"{kname}_{name}_host_ms"] = split["host_ms"]
        if name in ("isabel3d", "page0"):
            out[f"compress_cuda_{name}_ms"] = cuda_ms(
                lambda: codec.compress(x), 5)
        if name == "hacc1d":
            resid = codes[2].reshape(-1)
            two_eb = ops._two_eb_f32(c.eb)
            require(same(L.reconstruct1d(resid, two_eb),
                         L.reconstruct1d_plain(resid, two_eb)),
                    "hacc1d: reconstruct1d differs from its plain version")
            split = launch_split(lambda: L.reconstruct1d(resid, two_eb))
            out["reconstruct1d_hacc1d_ms"] = split["wrapper_ms"]
            out["reconstruct1d_hacc1d_device_ms"] = split["device_ms"]
            out["reconstruct1d_hacc1d_host_ms"] = split["host_ms"]
            # The library yardstick of rows 6 and 9: one PyTorch scan of
            # the same int32 residuals.
            out["cumsum_hacc1d_device_ms"] = launch_split(
                lambda: torch.cumsum(resid, 0, dtype=torch.int32))[
                    "device_ms"]
    return out


def run_ab(other: str, seed: int) -> list:
    """``time_kernels`` of the tree at ``other`` and of this one in turns,
    (other, this, this, other) twice, one process each: two builds of one
    kernel library cannot run in one process, and a host-bound row (a KV
    page's launch) differs more between processes than within one."""
    turns = []
    for tree, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)) * 2:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--time-kernels", root], capture_output=True, text=True)
        require(proc.returncode == 0,
                f"--time-kernels {root} exited {proc.returncode}:\n"
                f"{proc.stderr[-4000:]}")
        turns.append({"tree": tree, "root": root,
                      **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(f"ab {json.dumps(turns[-1])}", flush=True)
    return turns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="ROOT",
                    help="only time count_subseq, decode_tiles, "
                    "decode_padded, selfsync_intra (with their LUT in "
                    "shared and in device memory), the fused kernels and "
                    "epilogues (the 1-D epilogue also at radius 4 and 2), "
                    "lorenzo_quantize, histogram, pack_tiles and "
                    "reconstruct1d (through the wrapper and on the device "
                    "alone), the paths that run them and the batch "
                    "phase's decompress ways against those of the "
                    "checkout at ROOT, in turns (ROOT, this, this, ROOT; "
                    "twice)")
    ap.add_argument("--time-kernels", metavar="ROOT",
                    help="only time those kernels as built from ROOT's "
                    "src (one turn of --ab)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(
        args.time_kernels or ROOT), "src"))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if args.time_kernels:
        other = os.path.abspath(args.time_kernels) != ROOT
        print(json.dumps(time_kernels(args.seed, other)))
        return 0
    if args.ab:
        run_ab(os.path.abspath(args.ab), args.seed)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
        return 0

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.sz import compressor, lorenzo
    from repro_torch.kernels import _build, launches, ops
    from repro_torch.kernels import huffman_decode as K

    t_start = time.perf_counter()
    secs = _build.build()
    print(f"build: {secs:.2f} s for {len(_build.SIGNATURES)} kernels "
          f"(nvcc, sm_90a, in parallel)")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    fields = make_fields(args.seed)
    print(f"fields: {', '.join(f'{k} float32{list(v.shape)}' for k, v in fields.items())}"
          f" from seed {args.seed} in {time.perf_counter() - t0:.1f} s; "
          f"hacc1d is cut from HACC's {HACC_VALUES} values to {1 << 24}")

    xs = {k: torch.from_numpy(v).cuda() for k, v in fields.items()}
    torch.cuda.synchronize()

    # -- two-pass path: counts zeroed just before, read just after ----------
    results = {}
    launches.reset()
    for name, x in xs.items():
        codec = Codec(CodecConfig())
        t0 = time.perf_counter()
        c = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y = codec.decompress(c)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        results[name] = (codec, c, y, t1 - t0, t2 - t1)
    two_pass_launches = launches.counts()
    print(f"two-pass path launches: {json.dumps(two_pass_launches)}")
    for kname, n in two_pass_launches.items():
        if kname in TWO_PASS_KERNELS:
            require(n > 0, f"kernel {kname} was not launched on the "
                    f"two-pass path")
        else:
            require(n == 0, f"kernel {kname} was launched on the two-pass "
                    f"path")

    # -- fused path: counts zeroed just before, read just after -------------
    fused = {}
    launches.reset()
    for name, (_, c, _, _, _) in results.items():
        codec = Codec(CodecConfig(fused=True))
        before = launches.counts()
        t0 = time.perf_counter()
        y = codec.decompress(c)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = launches.counts()
        fused[name] = (codec, y, t1 - t0, dict(codec.stats),
                       {k: after[k] - before[k] for k in after})
    fused_launches = launches.counts()
    print(f"fused path launches: {json.dumps(fused_launches)}")
    for kname, n in fused_launches.items():
        if kname in FUSED_KERNELS:
            require(n > 0, f"kernel {kname} was not launched on the fused "
                    f"path")
        else:
            require(n == 0, f"kernel {kname} was launched on the fused path")

    # -- padded, padded fused and tuned paths: counts zeroed just before,
    # read just after each ----------------------------------------------------
    def drive(config):
        def run():
            out = {}
            for name, (_, c, _, _, _) in results.items():
                codec = Codec(config)
                codec.reset_stats()
                y = codec.decompress(c)
                out[name] = (codec, y, dict(codec.stats))
            return out
        return run

    padded, padded_launches = run_path(
        "padded", PADDED_KERNELS, drive(CodecConfig(strategy="padded")))
    padded_fused, padded_fused_launches = run_path(
        "padded fused", PADDED_FUSED_KERNELS,
        drive(CodecConfig(strategy="padded", fused=True)))
    tuned, tuned_launches = run_path("tuned", TUNED_KERNELS,
                                     drive(CodecConfig(strategy="tuned")))

    # -- checks ---------------------------------------------------------------
    rows = []
    for name, (codec, c, y, t_comp, t_dec) in results.items():
        x = xs[name]
        require(codec.device.type == "cuda" and c.device.type == "cuda"
                and y.device.type == "cuda", f"{name}: ran off the card")
        require(y.dtype == x.dtype and tuple(y.shape) == tuple(x.shape),
                f"{name}: output {y.dtype}{list(y.shape)}")
        require(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        want = lorenzo.quantize_host(x, c.eb, c.radius)[0].reshape(-1)
        got = codec.decode(c.stream, c.codebook, c.n_symbols)
        require(got.device.type == "cuda" and same(got, want),
                f"{name}: codes decoded on the card differ from the "
                f"quantization codes compress encoded")
        err = float((y.double() - x.double()).abs().max())
        require(err <= c.eb_effective,
                f"{name}: max|x - x'| = {err} > eb_effective "
                f"{c.eb_effective}")

        fcodec, fy, t_fused, fstats, flaunch = fused[name]
        fname = ("decode_tiles_fused" if len(x.shape) == 1
                 else "decode_tiles_fused_nd")
        require(fstats["fused_dispatches"] >= 1
                and fstats["fused_fallbacks"] == 0,
                f"{name}: fused path stats {fstats}")
        require(flaunch[fname] == 1 and flaunch["decode_tiles"] == 0,
                f"{name}: fused path launches {flaunch}")
        require(fy.device.type == "cuda" and same(fy, y),
                f"{name}: fused output differs from the two-pass output")

        count_args, tile_args = kernel_inputs(codec, c)
        kc, kl = K.count_subseq(*count_args)
        pc, pl = K.count_subseq_plain(*count_args)
        require(same(kc, pc) and same(kl, pl),
                f"{name}: count_subseq differs from its plain version")
        kt = K.decode_tiles(*tile_args)
        pt = K.decode_tiles_plain(*tile_args)
        require(same(kt, pt),
                f"{name}: decode_tiles differs from its plain version")
        ctile, class_args = class_tile_args(codec, c)
        kct = K.decode_tiles(*class_args)
        require(same(kct, K.decode_tiles_plain(*class_args))
                and same(kct, kt),
                f"{name}: decode_tiles at the class tile {ctile} differs from "
                f"its plain version")
        fkernel, fplain, fargs = fused_inputs(fcodec, c)
        require(fkernel.__name__ == fname, f"{name}: {fkernel.__name__}")
        kf = fkernel(*fargs)
        pf = fplain(*fargs)
        require(same(kf, pf),
                f"{name}: {fname} differs from its plain version")
        require(same(kf, y.reshape(-1)),
                f"{name}: {fname} differs from the two-pass output")

        pcodec, py, pstats = padded[name]
        require(py.device.type == "cuda" and same(py, y),
                f"{name}: padded output differs from the two-pass output")
        pfcodec, pfy, pfstats = padded_fused[name]
        ename = ("dequant_reconstruct" if len(x.shape) == 1
                 else "dequant_reconstruct_nd")
        require(pfstats["fused_dispatches"] == 1
                and pfstats["fused_fallbacks"] == 0,
                f"{name}: padded fused path stats {pfstats}")
        require(pfy.device.type == "cuda" and same(pfy, y),
                f"{name}: padded fused output differs from the two-pass "
                f"output")
        tcodec, ty, tstats = tuned[name]
        require(tstats["decode_write_dispatches"] <= tcodec.config.t_high + 1,
                f"{name}: tuned path stats {tstats}")
        require(ty.device.type == "cuda" and same(ty, y),
                f"{name}: tuned output differs from the two-pass output")
        kr, kpc = K.decode_padded(*count_args)
        pr, ppc = K.decode_padded_plain(*count_args)
        require(same(kr, pr) and same(kpc, ppc),
                f"{name}: decode_padded differs from its plain version")
        ekernel, eplain, eargs = ops.padded_epilogue_inputs(
            got, c.n_symbols, c.outlier_pos, c.outlier_val, c.eb, c.radius,
            c.shape, c.dtype)
        require(ekernel.__name__ == ename, f"{name}: {ekernel.__name__}")
        ke = ekernel(*eargs)
        pe = eplain(*eargs)
        require(same(ke, pe),
                f"{name}: {ename} differs from its plain version")
        require(same(ke[:c.n_symbols], y.reshape(-1)),
                f"{name}: {ename} differs from the two-pass output")
        torch.cuda.synchronize()

        # -- times ------------------------------------------------------------
        n_subseq = c.stream.n_subseq
        payload = c.stream.total_bits / 8
        n_outliers = int((c.outlier_pos >= 0).sum())
        out_bytes = c.n_symbols * x.element_size()
        row = {
            "field": name, "shape": list(x.shape), "ratio": c.ratio,
            "bits_per_code": c.stream.total_bits / c.n_symbols,
            "n_subseq": n_subseq, "n_outliers": n_outliers,
            "compress_s": t_comp, "first_decompress_s": t_dec,
            "first_fused_decompress_s": t_fused, "max_abs_err": err,
            "eb_effective": c.eb_effective,
            "count_subseq": {
                "ms": cuda_ms(lambda: K.count_subseq(*count_args), 20),
                "plain_ms": cuda_ms(lambda: K.count_subseq_plain(*count_args),
                                    2),
                "bound_ms": (payload + 16 * n_subseq) / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max(max_abs_diff(kc, pc),
                                   max_abs_diff(kl, pl))},
            "decode_tiles": {
                "ms": cuda_ms(lambda: K.decode_tiles(*tile_args), 20),
                "plain_ms": cuda_ms(lambda: K.decode_tiles_plain(*tile_args),
                                    1),
                "bound_ms": (payload + 12 * n_subseq + 2 * c.n_symbols)
                / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max_abs_diff(kt, pt),
                "class_tile": ctile,
                "class_tile_ms": cuda_ms(
                    lambda: K.decode_tiles(*class_args), 20)},
            fname: {
                "ms": cuda_ms(lambda: fkernel(*fargs), 20),
                "plain_ms": cuda_ms(lambda: fplain(*fargs), 1),
                "bound_ms": (payload + 12 * n_subseq + out_bytes
                             + 8 * n_outliers) / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max_abs_err(kf, pf)},
            "decode_padded": {
                "ms": cuda_ms(lambda: K.decode_padded(*count_args), 20),
                "plain_ms": cuda_ms(
                    lambda: K.decode_padded_plain(*count_args), 1),
                "bound_ms": (payload + (12 + 256 + 4) * n_subseq)
                / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max(max_abs_diff(kr, pr),
                                   max_abs_diff(kpc, ppc))},
            ename: {
                "ms": cuda_ms(lambda: ekernel(*eargs), 20),
                "plain_ms": cuda_ms(lambda: eplain(*eargs), 2),
                "bound_ms": (2 * c.n_symbols + out_bytes + 8 * n_outliers)
                / HBM_BYTES_PER_S * 1e3,
                "max_abs_err": max_abs_err(ke, pe)},
        }
        # The decode-work yardstick of decode_tiles: count_subseq runs the
        # same lane loop over the same windows and writes no codes.
        row["decode_tiles"]["decode_work_ms"] = row["count_subseq"]["ms"]
        row["dequantize_ms"] = cuda_ms(
            lambda: compressor._dequantize(c, got), 10)
        row["plan_ms"] = cuda_ms(
            lambda: codec.build_plan(c.stream, c.codebook), 5)
        row["decompress_cached_plan_ms"] = cuda_ms(
            lambda: codec.decompress(c), 10)
        row["decompress_fused_cached_plan_ms"] = cuda_ms(
            lambda: fcodec.decompress(c), 10)
        row["decompress_padded_cached_plan_ms"] = cuda_ms(
            lambda: pcodec.decompress(c), 5)
        row["decompress_padded_fused_cached_plan_ms"] = cuda_ms(
            lambda: pfcodec.decompress(c), 5)
        row["decompress_tuned_cached_plan_ms"] = cuda_ms(
            lambda: tcodec.decompress(c), 5)
        row["tuned_dispatches"] = tstats["decode_write_dispatches"]
        # phases 1-4 of each strategy, as decode_ms is for "tile"
        row["decode_ms_padded"] = cuda_ms(
            lambda: pcodec.decode(c.stream, c.codebook, c.n_symbols), 5)
        row["decode_ms_tuned"] = cuda_ms(
            lambda: tcodec.decode(c.stream, c.codebook, c.n_symbols), 5)
        # The torch-ops dequantize beside the epilogue kernel.
        row[ename]["torch_ops_ms"] = row["dequantize_ms"]
        if ename == "dequant_reconstruct":
            row[ename]["device_ms"] = launch_split(
                lambda: ekernel(*eargs))["device_ms"]
        row["decompress_with_plan_ms"] = cuda_ms(
            lambda: compressor.decompress(c, backend=codec.backend), 5)
        row["decompress_fused_with_plan_ms"] = cuda_ms(
            lambda: compressor.decompress(c, backend=fcodec.backend,
                                          fused=True), 5)
        # The paper's decoder throughput: phases 1-4 (plan built, no
        # dequantize) over the quant-code bytes, 2 B per code.
        row["decode_ms"] = cuda_ms(
            lambda: codec.decode(c.stream, c.codebook, c.n_symbols), 5)
        for key, ms in (
                ("decode_gbps", row["decode_ms"]),
                ("decompress_gbps", row["decompress_with_plan_ms"]),
                ("decompress_fused_gbps",
                 row["decompress_fused_with_plan_ms"])):
            row[key] = c.quant_code_bytes / (ms * 1e-3) / 1e9
        rows.append(row)
        print(f"field {json.dumps(row)}")

    # -- the device-memory LUT variants: isabel3d's windows through its
    # table widened to 2**LONG_MAX_LEN entries ------------------------------
    long_codes = long_code_kernels(*results["isabel3d"][:2])
    print(f"long codes {json.dumps(long_codes)}")

    selfsync = run_selfsync(results)
    batch = run_batch(args.seed, results, xs)
    encode = run_encode(args.seed, xs)
    chunked = run_chunked(results, rows, selfsync)
    store = run_store(args.seed, xs)
    del xs, results, fused, padded, padded_fused, tuned
    torch.cuda.empty_cache()
    model = run_model(args.seed)
    pager = run_pager(args.seed)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    # Each kernel's numbers on the field of the smoke run that drives it:
    # isabel3d for the two-pass, N-D and write-path kernels, hacc1d for the
    # 1-D kernels.  Launch counts are those of each path's run.
    by_field = {r["field"]: r for r in rows}
    for name, row in encode["fields"].items():
        by_field[name] = {**by_field.get(name, {}), **{
            k: v for k, v in row.items() if isinstance(v, dict)}}
    by_field["isabel3d"]["selfsync_intra"] = (
        selfsync["fields"]["isabel3d"]["selfsync_intra"])
    kernels = []
    for kname, field, counts in (
            ("count_subseq", "isabel3d", two_pass_launches),
            ("decode_tiles", "isabel3d", two_pass_launches),
            ("decode_padded", "isabel3d", padded_launches),
            ("decode_tiles_fused", "hacc1d", fused_launches),
            ("decode_tiles_fused_nd", "isabel3d", fused_launches),
            ("dequant_reconstruct", "hacc1d", padded_fused_launches),
            ("dequant_reconstruct_nd", "isabel3d", padded_fused_launches),
            ("lorenzo_quantize", "isabel3d", encode["launches"]),
            ("reconstruct1d", "hacc1d", encode["reconstruct_launches"]),
            ("histogram", "isabel3d", encode["launches"]),
            ("pack_tiles", "isabel3d", encode["launches"]),
            ("selfsync_intra", "isabel3d", selfsync["launches"])):
        k = by_field[field][kname]
        entry = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": k.get("library_ms")}
        for key in ("torch_ops_ms", "device_ms"):
            if key in k:
                entry[key] = k[key]
        kernels.append(entry)
    # Row 6's library yardstick is row 9's: torch.cumsum of hacc1d's int32
    # residuals, the same scan, which reads 4 B a value where row 6 reads
    # 2 B a code.
    kernels[5]["library_ms"] = kernels[8]["library_ms"]
    kernels[5]["library_call"] = ("torch.cumsum(resid, 0, dtype=torch.int32)"
                                  " on hacc1d's int32 residuals (4 B read a "
                                  "value; the kernel reads 2 B a code)")
    quantize_1d = by_field["hacc1d"]["lorenzo_quantize"]
    kernels[7]["hacc1d"] = {key: quantize_1d[key] for key in (
        "ms", "plain_ms", "bound_ms", "max_abs_err")}
    kernels[2]["fields_ms"] = {r["field"]: r["decode_padded"]["ms"]
                               for r in rows}
    kernels[2]["fields_bound_ms"] = {
        r["field"]: r["decode_padded"]["bound_ms"] for r in rows}
    kernels[11].update({key: by_field["isabel3d"]["selfsync_intra"][key]
                        for key in SELFSYNC_EXTRA_KEYS})
    kernels[0]["fields_ms"] = {r["field"]: r["count_subseq"]["ms"]
                               for r in rows}
    kernels[1].update({key: by_field["isabel3d"]["decode_tiles"][key]
                       for key in ("decode_work_ms", "class_tile",
                                   "class_tile_ms")})
    kernels[1]["batch_launches"] = batch["launches"]["decode_tiles"]
    kernels[1]["batch_merged_lut"] = batch["merged_lut_kernel"]
    # Rows 5 and 7 on both N-D fields; rows 8, 10 and 11 on one KV page,
    # whose 256 launches the encode path runs besides the fields'.
    for i, kname in ((4, "decode_tiles_fused_nd"),
                     (6, "dequant_reconstruct_nd")):
        kernels[i]["fields_ms"] = {r["field"]: r[kname]["ms"] for r in rows
                                   if kname in r}
        kernels[i]["fields_bound_ms"] = {
            r["field"]: r[kname]["bound_ms"] for r in rows if kname in r}
    hist = {f: by_field[f]["histogram"] for f in fields}
    kernels[9].update(fields_ms={f: h["ms"] for f, h in hist.items()},
                      fields_device_ms={f: h["device_ms"]
                                        for f, h in hist.items()},
                      fields_bound_ms={f: h["bound_ms"]
                                       for f, h in hist.items()})
    for i, kname in ((7, "lorenzo_quantize"), (9, "histogram"),
                     (10, "pack_tiles")):
        page = by_field["page0"][kname]
        kernels[i]["page"] = {key: page[key] for key in (
            "ms", "plain_ms", "bound_ms", "max_abs_err", "device_ms",
            "host_ms") if key in page}
        kernels[i]["page"]["shape"] = list(PAGE_SHAPE)
    # The device-memory LUT variants (max_len LONG_MAX_LEN) of rows 1, 3
    # and 12 beside their shared-memory times on the same windows.
    for i, kname in ((0, "count_subseq"), (2, "decode_padded"),
                     (11, "selfsync_intra")):
        kernels[i]["global_lut"] = {
            "max_len": long_codes["max_len"],
            "ms": long_codes[f"{kname}_global_ms"],
            "smem_lut_ms": long_codes[f"{kname}_smem_ms"]}
    for kname, k in model["kernels"].items():
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "serve_launches": k["serve_launches"], "shape": k["shape"],
            "dtype": k["dtype"], **{key: k[key] for key in (
                "decode_shape", "decode_ms", "decode_device_ms",
                "decode_bound_ms") if key in k}})
    require(len(kernels) == len(REPLACES),
            f"{len(kernels)} kernel rows for {len(REPLACES)} TPU kernels")
    # The yardsticks: kernels of the port that replace no TPU kernel.
    k = chunked["kernel"]
    kernels.append({
        "name": "decode_chunked", "route": "cuda",
        "source": SOURCES["decode_chunked"], "replaces": None,
        "yardstick": YARDSTICKS["decode_chunked"],
        "launches": chunked["launches"]["decode_chunked"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "field": "hacc1d",
        "chunk_symbols": CHUNK_SIZES[0], "fields_ms": k["fields_ms"]})
    require(len(kernels) == len(REPLACES) + len(YARDSTICKS)
            == len(_build.SIGNATURES),
            f"{len(kernels)} kernel rows for {len(REPLACES)} TPU kernels, "
            f"{len(YARDSTICKS)} yardsticks and {len(_build.SIGNATURES)} "
            f"kernel libraries")
    print(f"table V {json.dumps(table_v(chunked))}")
    print(f"store and pager {json.dumps(store_summary(store, pager))}")
    print(json.dumps({"kernels": kernels}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
