#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

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
    memory).

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
    every batch output equals its tensor's own ``decompress``, with at most
    ``t_high + 1`` decode-write dispatches for the whole batch;
  * prints CUDA-event times of each kernel, its plain version and its byte
    bound, the two-pass dequantize, the plan and the whole ``decompress`` of
    every path; the decode throughput (phases 1-4) and the ``decompress``
    throughputs in GB/s of quant codes (2 B per code); the card's name and
    power limit; and a ``kernels`` JSON line.

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
sys.path.insert(0, os.path.join(ROOT, "src"))

#: Published HBM3 bandwidth of the H100 SXM (bytes/s), for the byte bounds.
HBM_BYTES_PER_S = 3.35e12
#: The TPU kernels these CUDA kernels replace (file:line of the def).
REPLACES = {"count_subseq": "src/repro/kernels/huffman_decode.py:52",
            "decode_tiles": "src/repro/kernels/huffman_decode.py:105",
            "decode_padded": "src/repro/kernels/huffman_decode.py:157",
            "decode_tiles_fused": "src/repro/kernels/fused_decode.py:155",
            "decode_tiles_fused_nd": "src/repro/kernels/fused_decode.py:222",
            "dequant_reconstruct": "src/repro/kernels/fused_decode.py:295",
            "dequant_reconstruct_nd":
                "src/repro/kernels/fused_decode.py:343"}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
#: The kernels each path must launch; every other kernel must not launch.
TWO_PASS_KERNELS = ("count_subseq", "decode_tiles")
FUSED_KERNELS = ("count_subseq", "decode_tiles_fused",
                 "decode_tiles_fused_nd")
PADDED_KERNELS = ("count_subseq", "decode_padded")
PADDED_FUSED_KERNELS = ("count_subseq", "decode_padded",
                        "dequant_reconstruct", "dequant_reconstruct_nd")
TUNED_KERNELS = ("count_subseq", "decode_tiles")
BATCH_KERNELS = ("count_subseq", "decode_tiles")
HACC_VALUES = 280_953_867
#: KV-cache pages of the batch phase, each shaped like one Qwen3-0.6B page:
#: (K/V, KV heads, tokens, head_dim).
N_PAGES = 256
PAGE_SHAPE = (2, 8, 16, 128)


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


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, warmed up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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
    from repro_torch.kernels import ops

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
    # against its plain version (a recording backend replays the batch).
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return ops.decode_write_tiles(*a, **kw)

    cuda_be = hp.get_backend("cuda")
    rec = hp.DecodeBackend(name="record", count_fn=cuda_be.count_fn,
                           tiles_fn=record, padded_fn=cuda_be.padded_fn)
    plans = [codec.plan_for(c) for c in cs]
    replay = hp.decode_batch([c.stream for c in cs], [c.codebook for c in cs],
                             [c.n_symbols for c in cs], plans=plans,
                             backend=rec)
    require(all(same(r, q) for r, q in zip(
        replay, hp.decode_batch([c.stream for c in cs],
                                [c.codebook for c in cs],
                                [c.n_symbols for c in cs], plans=plans,
                                backend="cuda"))),
            "batch: replayed decode differs")
    (units, ds, dl, starts, ends, offsets, total_bits, max_len, n_out, tile,
     ss_max), kw = max(calls, key=lambda call: call[0][8])
    s0 = ops._tile_inputs(offsets, starts.shape[0], n_out, tile)
    targs = (units, starts, ends, offsets, s0, total_bits, ds, dl, max_len,
             tile, ss_max, n_out, kw["lut_base"])
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2

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
                "max_abs_err": max_abs_diff(kt, pt)},
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
        # The torch-ops dequantize beside the epilogue kernel: no single
        # PyTorch call computes this function.
        row[ename]["torch_ops_ms"] = row["dequantize_ms"]
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

    batch = run_batch(args.seed, results, xs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    # Each kernel's numbers on the field of the smoke run that drives it:
    # isabel3d for the two-pass kernels and the N-D fused kernel, hacc1d for
    # the 1-D fused kernel.  Launch counts are those of each path's run.
    by_field = {r["field"]: r for r in rows}
    kernels = []
    for kname, field, counts in (
            ("count_subseq", "isabel3d", two_pass_launches),
            ("decode_tiles", "isabel3d", two_pass_launches),
            ("decode_padded", "isabel3d", padded_launches),
            ("decode_tiles_fused", "hacc1d", fused_launches),
            ("decode_tiles_fused_nd", "isabel3d", fused_launches),
            ("dequant_reconstruct", "hacc1d", padded_fused_launches),
            ("dequant_reconstruct_nd", "isabel3d", padded_fused_launches)):
        k = by_field[field][kname]
        entry = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": None}
        if "torch_ops_ms" in k:
            entry["torch_ops_ms"] = k["torch_ops_ms"]
        kernels.append(entry)
    kernels[1]["batch_launches"] = batch["launches"]["decode_tiles"]
    kernels[1]["batch_merged_lut"] = batch["merged_lut_kernel"]
    print(json.dumps({"kernels": kernels}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
