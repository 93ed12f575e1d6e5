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
  * families, the attention options: h2o-danube-1.8b (all 24 layers,
    float32 parameters) prefilling B 1 x 8,192 tokens through the
    windowed ``flash_attention`` (window 4,096; 24 launches), whisper-base
    prefilling B 4 x 448 tokens over 1,500 stub frames (18 launches: 6
    encoder, 6 decoder, 6 cross-attention) and qwen2-vl-72b at full width
    cut to 8 of its 80 layers prefilling B 1 x (256 patches + 768 tokens)
    with M-RoPE (8 launches); float32 step decode against the forward a
    family; ``launch.serve.main`` of danube and of whisper
    (``--compress-kv`` through a "cuda"-encode codec); the reduced
    danube's decode past its ring buffer's wrap, the card against the CPU;
    qwen3-0.6b's int8 KV cache against its bf16 cache (B 4, 32 steps);
    one reduced train step of whisper-base and danube, the card against
    the CPU;
  * moe, qwen2-moe-a2.7b (60 routed experts of width 1,408, top 4, 4
    shared; all 24 layers, float32 parameters) prefilling B 4 x 1,024
    tokens (capacity 341 an expert; 24 ``flash_attention`` launches and
    no other kernel: routing, dispatch and the expert GEMMs are torch
    ops), its aux loss and dropped share; float32 step decode against the
    forward at capacity factor 15 (no drop); ``launch.serve.main`` plain
    and with ``--compress-kv`` through a "cuda"-encode codec; 2 of its
    layers trained 2 ``make_train_step`` steps at B 2 x 512 (4
    ``flash_attention`` launches a step); the reduced train step,
    ``moe_block`` at capacity factor 0.5 (drops) and ``route``, the card
    against the CPU;
  * mla, deepseek-v3-671b (multi-head latent attention, 256 routed
    experts of 2,048, top 8, one shared, the MTP head) at its published
    widths cut to 4 of its 61 layers (the 3 dense-prefix layers and one
    MoE layer; bf16 parameters, 32.2 GB) prefilling B 2 x 2,048 tokens
    (4 ``flash_attention`` launches at D 192 over Dv 128, one a layer,
    and no other kernel), its aux loss and dropped share; the kernel at
    layer 0's inputs beside its bound and each SDPA backend that takes D
    != Dv; a greedy decode loop through ``make_serve_step`` at B 4 (the
    latent cache attended in torch ops, no kernel); float32 step decode
    against the forward (float32 parameters, 64.3 GB; the float32 kernel
    at D 192) at capacity factor 32; ``launch.serve.main`` of the reduced
    config plain and with ``--compress-kv`` (the latent cache through a
    "cuda"-encode codec); the gradient of 2 layers (1 dense, 1 MoE) and
    the MTP head at B 1 x 512 (remat: 5 ``flash_attention`` launches, the
    MTP block's outside remat); the reduced train step (AdamW, float32
    parameters), the card against the CPU;
  * hybrid, zamba2-7b (81 Mamba2 layers, chunked SSD in torch ops, and
    one weight-shared attention block, 32 heads of 112, window 4,096,
    run after every 6th layer) at its published widths and full depth
    (bf16 parameters, 13.50 GB) prefilling B 1 x 8,192 tokens (13 windowed
    ``flash_attention`` launches, one an invocation, and no other
    kernel), with the profiler's idle share; the kernel at the block's
    first invocation (its inputs after the SSM layers 0-5) beside its
    bound and SDPA with the boolean window mask; a greedy decode loop
    through ``make_serve_step`` at B 4 (no kernel); float32 step decode
    against the forward (float32 parameters, 27 GB; the float32 kernel at
    D 112); ``launch.serve.main`` plain and with ``--compress-kv`` (the
    whole cache, SSM state included, through a "cuda"-encode codec), and
    the reduced config with ``--kv-offload`` (``k``, ``v`` paged); the
    gradient and one AdamW step of 12 layers (two invocations) at B 1 x
    2,048 (remat: 4 ``flash_attention`` launches); the reduced train step
    (float32 parameters), the card against the CPU;
  * train, A10's training half: qwen3-0.6b at full width trained by
    ``launch.train.main`` (4 steps at B 4 x 1024, float32 parameters,
    bf16 compute, remat, no checkpoint), whose attention runs
    ``flash_attention`` twice a layer a step (the forward and remat's
    recompute, inside ``flash_attention_trainable``; its backward torch
    ops); rwkv6-3b at full width cut to 2 layers (2 ``make_train_step``
    steps at B 2 x 512) through ``gla_time_mix_trainable`` (the kernel a
    64-step chunk, forward and recompute); one reduced train step a family
    on the card and on the CPU from the same parameters and batch; the
    reduced qwen3 preempted at step 3 (exit 17) and resumed from its
    compressed checkpoint (``count_subseq``, ``decode_tiles``);
  * pager, qwen3-0.6b's prefill at B 4 x 1024 kept as its decode cache
    (k, v bf16 (28, 4, 1024, 8, 128)), tokens [256, 768) offloaded by
    ``KVPager`` through a "cuda"-encode codec (``lorenzo_quantize``,
    ``histogram``, ``pack_tiles``) and paged back in (``count_subseq``,
    ``decode_tiles``);
  * checkpoint, qwen3-0.6b's 596,049,920 float32 parameters stacked into
    the reference's layout (``convert.stack_layers``) and saved by
    ``CheckpointManager`` through a "cuda"-encode codec at eb 1e-4
    (``lorenzo_quantize``, ``histogram``, ``pack_tiles``), step 1 at once
    and step 2 asynchronously, then restored cold and warm and past a
    torn manifest (``count_subseq``, ``decode_tiles``);
  * faults, the seed-0 fault-injection campaign of 200 cases with every
    decode on the card (``count_subseq``, ``decode_tiles`` on corrupt
    streams, gap arrays, outlier lists and tables);
  * serve kv, ``launch.serve.main`` of qwen3-0.6b at full width (B 4, a
    128-token prompt, 8 generated) with ``--kv-offload --kv-block 32``
    through a "cuda"-encode codec, with ``--concurrency`` 1 and 4 (the
    serving scheduler), then ``--compress-kv``;
  * loadgen, the serving load generator at qwen3-0.6b's KV shape (16
    tokens a block, 4 shared prefix blocks and one unique block a
    session, 100 sessions at 400 a second): the baseline, then the
    scheduler with and without overlap, and without and with again
    (``count_subseq``, ``decode_tiles``);
  * sharded, qwen3-0.6b's parameters saved by ``CheckpointManager`` on
    the reference's {data: 4, model: 2} layout in 4 shards (58 tiles,
    "cuda" encode), restored cold and warm as full tensors and into
    ``make_host_mesh()`` as DTensors, one host's share decoded by
    ``ShardedRestorer.decode_shards([0])``, then shard 1 overwritten by
    4 KiB and restored under "raise" and "zero_fill"; then
    ``make_dp_gradient_sync`` on a [28, 1024, 3072] gradient over the
    one-rank NCCL group against the same call over gloo on the CPU;
  * naive_ref, ``Codec(CodecConfig(method="naive_ref"))`` on the three
    fields: no plan, the whole stream in one sequential scan through the
    ``decode_chunked`` kernel (the stream as its one chunk, one thread),
    bit-equal to the two-pass output and to the gap decode's codes;
  * examples, the six ``examples/*_torch.py`` twins, each as its own
    process on the card (``train_e2e_torch.py`` at 60 steps);
  * dryrun, every cell of ``configs.cells()`` on both production layouts
    (66) through ``launch/dryrun.run_cell``, traced on ``meta`` in a pool
    of CPU processes started after the build and read at the end, then
    one cross-check: qwen3-0.6b's prefill (B 4 x 1024) on a {data: 1,
    model: 1} layout against the same step run on the card (parameter
    bytes, ``flash_attention`` launches, ``FlopCounterMode``'s matrix
    FLOPs, the peak within 2x), its roofline bound beside its time.

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
    within 2e-5; gla within 1e-4 of the output's scale), flash also at the
    attention families' layer-0 inputs (danube's windowed); the prefill
    logits are finite and of the expected shape; the reduced danube's
    decode on the card within 1e-4 of the CPU's, logits and caches; the
    int8 KV decode's logits within 0.25 of the bf16 cache's with equal
    argmax wherever the bf16 top-2 gap exceeds 0.25; the float32 step-decode
    logits are within ``DECODE_F32_TOL`` of the forward's at every
    position, with equal argmax wherever the top-2 gap exceeds it;
    ``decode_chunked`` equals its plain version bit for bit at every block
    width it takes and its first n codes equal ``Codec.decode``'s; the
    tree's decoded leaves equal ``decompress_batch`` of the same payloads
    bit for bit and every other leaf comes back as the same object; the
    archive reads back bit for bit, the warm read builds zero plans and
    hits the codebook cache; the paged tokens come back within the
    codec's bound (``eb_effective`` with the cast to bf16), zeroed in
    between, and a second page-in builds zero plans; the checkpoint's
    compressed leaves are within ``eb_effective`` of the parameters and
    equal ``decompress_batch`` of their archive payloads bit for bit, its
    raw leaves come back bit for bit, a warm restore builds zero plans and
    the torn restore lands on step 1 with ``fallback_from`` set; the
    campaign has no silent, unnamed or hanging case; the two offloading
    serve runs give the same tokens, their ``kv_err`` within the blocks'
    ``eb_effective`` with the bf16 cast, the scheduler decoding 4 blocks
    for 16 requests, 12 of them hits or coalesced; the load generator's
    scheduler runs hold its invariants, and every block they served
    equals ``pager.fetch`` of it bit for bit; every tile of the sharded
    checkpoint equals ``decompress_batch`` of its shard chunk bit for bit
    and is within its ``eb_effective``, raw leaves bit for bit, each
    DTensor's ``to_local()`` equals the full restore, warm restores build
    zero plans, "raise" names the overwritten shard, "zero_fill"
    quarantines exactly the entries whose chunks the store's CRC check
    rejects (zeros) and every other entry is intact; the NCCL and gloo
    gradient syncs are equal bit for bit; the trainable functions'
    gradients on the card equal autograd's through their plain versions
    (flash within one bf16 ulp of each gradient's scale in bf16, 1e-4 of
    it in float32; gla within 1e-4 of it) at layer 0's shapes and on the
    random cases, the reduced train step's loss, gradients, grad norm and
    updated parameters on the card those on the CPU (1e-5 relative, 1e-4
    of each gradient's scale, 1e-5, a quarter of the learning rate), the
    training losses finite, 24 ``flash_attention`` launches in the moe
    prefill and 4 a 2-layer moe train step, its aux above 0, the reduced
    ``moe_block`` with drops on the card within 1e-5 of its scale of the
    CPU's (aux 1e-6 relative) and ``route`` on the card equal to the CPU's
    on the same logits, 56 ``flash_attention`` launches a qwen3 step
    and 32 ``gla_time_mix`` launches a 2-layer rwkv6 step, the preempted
    run's exit code 17 and the resumed run's steps 4 and 5;
  * prints CUDA-event times of each kernel, its plain version and its byte
    bound, the two-pass dequantize, the plan and the whole ``decompress`` of
    every path; the decode throughput (phases 1-4) and the ``decompress``
    throughputs in GB/s of quant codes (2 B per code); ``compress`` with the
    "ref" and "cuda" encode backends; the gap and self-sync plan times, the
    passes and rounds of the self-sync and the decode throughput of ori and
    opt self-sync; the model phase's prefill ms and tokens/s, serve
    tokens/s and peak memory a config; the ``families`` row (each family's
    prefill ms, launches, layer-0 kernel checks and times, decode checks,
    serve row, peak memory; danube's windowed kernel beside its bound and
    SDPA with the boolean window mask; the int8 and bf16 caches' decode
    tokens a second); the ``moe`` row (prefill ms, tokens a second, peak
    memory, aux, dropped share, the kernel at layer 0 beside its bound and
    SDPA, the float32 decode check, serve tokens a second plain and with
    ``--compress-kv``, the 2-layer train steps' ms, losses and peak
    memory, the card-against-CPU checks); the ``mla`` row (the same for
    deepseek-v3-671b's 4 layers, the decode loop's tokens a second, the
    2-layer gradient's ms, peak memory and metrics); the ``hybrid`` row
    (zamba2-7b: prefill ms, tokens a second, peak memory and idle share,
    the kernel at the shared block's first invocation, the decode loop,
    the float32 decode check, the serve runs, the 12-layer gradient and
    AdamW step); the model kernels' times beside
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
    pager``); the consumer phases' rows (``checkpoint``, ``faults``,
    ``serve kv``, ``loadgen``, ``sharded``: save, async save and restore
    ms, bytes on disk, ratio and outlier share; outcome counts; each serve
    run's wall time, ``kv_err`` and ratios; p50 / p99 TTFT and dispatches
    a request of each load mode; the sharded save, cold, warm and mesh
    restores, one shard's decode, the salvage, the quarantined names and
    the gradient sync's NCCL and gloo times) and their summary
    (``consumers``); the ``train`` row (each qwen3 step's ms, the median
    after step 0, tokens a second, peak memory, first and last loss,
    launches a step, the last step's profile with the device's idle
    share; the attention backward's ms at layer 0's shape beside
    autograd's through the plain version; the rwkv6 steps and the GLA
    backward's ms; the restore's launches); and a ``kernels``
    JSON line, one row a TPU kernel of the
    repo (fourteen) and one for the yardstick ``decode_chunked``
    (``replaces`` null, ``yardstick`` the reference function), with rows
    5 and 7 on both N-D fields, rows 13 and 14 with their train phase
    launches and backward ms, row 13 with its windowed shape, the
    families' prefill launches and the moe, mla and hybrid phases'
    launches and layer-0 (hybrid: first-invocation) shapes, row 10 on all
    three
    fields, rows 8, 10 and 11 also on one KV page, and rows 1, 3 and 12
    also through their device-memory LUT, rows 1, 2, 8, 10 and 11 with
    their launches on the five consumer phases (``consumer_launches``).  Each
    time is read after
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
#: The two-pass dequantize's epilogue kernels on the card: 1-D, and 2-D /
#: 3-D after the unit axes are squeezed (``compressor._dequantize``).  A
#: read of the three fields launches both.
DEQUANT_KERNELS = ("dequant_reconstruct", "dequant_reconstruct_nd")
#: The kernels each path must launch; every other kernel must not launch.
#: ``run_path`` holds the epilogues, where a path does not name them, to
#: exactly the launches its two-pass reads take (``dequant_launches``).
TWO_PASS_KERNELS = ("count_subseq", "decode_tiles", *DEQUANT_KERNELS)
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
#: The checkpoint phase: qwen3-0.6b's float32 parameters at ``--ckpt-
#: compress-eb 1e-4`` (the training launcher's flag) and the manager's
#: default size floor.
CKPT_VALUES = 596_049_920
CKPT_EB = 1e-4
CKPT_MIN_SIZE = 65_536
CHECKPOINT_KERNELS = ("lorenzo_quantize", "histogram", "pack_tiles",
                      "count_subseq", "decode_tiles")
#: The fault campaign on the card: the reference's CI campaign.
FAULT_CASES = 200
FAULT_KERNELS = ("count_subseq", "decode_tiles")
#: ``serve.main``'s KV paths: a 128-token prompt in blocks of 32, 8
#: generated, 4 lanes through the scheduler.
SERVE_PROMPT, SERVE_GEN, SERVE_KV_BLOCK, SERVE_LANES = 128, 8, 32, 4
SERVE_KV_KERNELS = ("lorenzo_quantize", "histogram", "pack_tiles",
                    "count_subseq", "decode_tiles")
#: The load generator at qwen3-0.6b's KV shape: 16 tokens a block (vLLM's
#: default block size), 4 shared prefix blocks and one unique a session.
LOAD_SESSIONS, LOAD_PREFIX, LOAD_TOKENS, LOAD_RATE = 100, 4, 16, 400.0
LOADGEN_KERNELS = ("count_subseq", "decode_tiles")
#: The mesh-sharded checkpoint: qwen3-0.6b on the reference's (4, 2)
#: layout in 4 shards, 58 tiles (the 7 layer matrices in 8, embed in 2);
#: the salvage restores decode with the plans the cold restore built.
SHARD_LAYOUT = {"data": 4, "model": 2}
SHARD_COUNT = 4
SHARD_TILES = 58
SHARDED_KERNELS = ("lorenzo_quantize", "histogram", "pack_tiles",
                   "count_subseq", "decode_tiles")
SALVAGE_KERNELS = ("decode_tiles",)
#: The compressed gradient sync: one of qwen3-0.6b's MLP matrices.
GRAD_SHAPE = (28, 1024, 3072)
GRAD_EB = 1e-7
#: The train phase: qwen3-0.6b at full width trained by launch/train.py
#: (remat on, float32 parameters, bfloat16 compute), rwkv6-3b at full
#: width cut to 2 layers, and the reduced configs of the card-against-CPU
#: step (float32 compute, AdamW at TRAIN_CHECK_LR) and of the preempt and
#: resume.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 1024
RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = 2, 2
RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ = 2, 512
TRAIN_CHECK_LR = 1e-3
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 4, 64
#: The train row whose run each model kernel's ``train_launches`` counts.
TRAIN_RUNS = {"flash_attention": "qwen3-0.6b", "gla_time_mix": "rwkv6-3b"}
#: The attention-families phase: h2o-danube-1.8b (all 24 layers, float32
#: parameters) prefilling B 1 x 8,192 tokens, past its 4,096-token window;
#: whisper-base (full) prefilling B 4 x 448 tokens over 1,500 frames;
#: qwen2-vl-72b at full width cut from 80 to VLM_LAYERS layers (80 layers
#: are ~145 GB of bf16 weights, past one card's 80 GB), prefilling B 1 x
#: (256 patches + 768 tokens).  Then float32 step decode against the
#: forward (B 1, FAMILY_DECODE_LEN tokens) a family, the reduced danube's
#: ring buffer past its wrap (window 32, WRAP_STEPS steps) on the card
#: against the CPU, and qwen3-0.6b's int8 KV cache (B INT8_BATCH,
#: INT8_STEPS steps) against its bf16 cache at the reference's tolerance
#: (TestKVQuantFamilywide: logits within 0.25, equal argmax).
DANUBE_BATCH, DANUBE_LEN = 1, 8192
WHISPER_BATCH, WHISPER_LEN = 4, 448
VLM_LAYERS, VLM_BATCH, VLM_PATCHES, VLM_LEN = 8, 1, 256, 768
FAMILY_DECODE_LEN = 32
WRAP_STEPS = 40
INT8_BATCH, INT8_STEPS, INT8_TOL = 4, 32, 0.25
FAMILY_ARCHS = ("h2o-danube-1.8b", "whisper-base", "qwen2-vl-72b")
#: The moe phase: qwen2-moe-a2.7b at full width, all 24 layers, float32
#: parameters (14,315,487,232: 57.26 GB), prefilling B MOE_BATCH x
#: MOE_LEN; float32 step decode against the forward (B 1 x
#: FAMILY_DECODE_LEN) at capacity factor n_experts / top_k (every token
#: fits its experts, nothing drops); serve.main, plain and --compress-kv;
#: MOE_TRAIN_LAYERS of its layers trained MOE_TRAIN_STEPS steps at B
#: MOE_TRAIN_BATCH x MOE_TRAIN_SEQ; on the reduced config the train step,
#: moe_block at MOE_DROP_CF (drops) and route, the card against the CPU.
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_BATCH, MOE_LEN = 4, 1024
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 2
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 512
MOE_DROP_CF = 0.5
#: The card-against-CPU moe_block check holds when no token's k-th and
#: (k+1)-th gates lie this close (the two float32 routers sum apart).
MOE_TIE_GAP = 1e-5
#: The mla phase: deepseek-v3-671b at its published widths cut in depth
#: to MLA_LAYERS layers (its 3 dense-prefix layers and 1 MoE layer, with
#: the MTP head: 16.1 B parameters, 32.2 GB in bf16; 61 layers are ~1.34
#: TB), prefilling B MLA_BATCH x MLA_LEN through flash_attention at a
#: 192-wide query/key head over a 128-wide value head; a greedy decode
#: loop of MLA_DECODE_STEPS steps at B MLA_DECODE_BATCH; float32 step
#: decode against the forward (float32 parameters, 64.3 GB; B 1 x
#: FAMILY_DECODE_LEN) at capacity factor n_experts / top_k; serve.main of
#: the reduced config, plain and --compress-kv; the gradient of
#: MLA_TRAIN_LAYERS layers (1 dense, 1 MoE) with the MTP head at B
#: MLA_TRAIN_BATCH x MLA_TRAIN_SEQ (AdamW's state would not fit beside
#: the bf16 parameters and gradients); the reduced train step (AdamW, the
#: card against the CPU).
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS, MLA_BATCH, MLA_LEN = 4, 2, 2048
MLA_DECODE_BATCH, MLA_DECODE_STEPS = 4, 32
MLA_TRAIN_LAYERS, MLA_TRAIN_BATCH, MLA_TRAIN_SEQ = 2, 1, 512
#: The hybrid phase: zamba2-7b at its published widths and full depth (81
#: Mamba2 layers, the shared block after every 6th: 13 invocations;
#: 6,748,175,952 bf16 parameters, 13.50 GB) prefilling B HYBRID_BATCH x
#: HYBRID_LEN (past the block's window of 4,096); a greedy decode loop of
#: HYBRID_DECODE_STEPS steps at B HYBRID_DECODE_BATCH after a prompt of
#: HYBRID_DECODE_PROMPT; float32 step decode against the forward (float32
#: parameters, 27 GB; B 1 x HYBRID_F32_LEN); serve.main plain and
#: --compress-kv, and the reduced config with --kv-offload in blocks of
#: HYBRID_KV_BLOCK; the gradient and one AdamW step of HYBRID_TRAIN_LAYERS
#: layers (two invocations) at B HYBRID_TRAIN_BATCH x HYBRID_TRAIN_SEQ;
#: the reduced train step (float32 parameters), the card against the CPU.
HYBRID_ARCH = "zamba2-7b"
HYBRID_BATCH, HYBRID_LEN = 1, 8192
HYBRID_DECODE_BATCH, HYBRID_DECODE_PROMPT, HYBRID_DECODE_STEPS = 4, 32, 32
HYBRID_F32_LEN = 64
HYBRID_KV_BLOCK = 8
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ = 12, 1, 2048


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


def dequant_launches(cs) -> dict:
    """``{kernel: launches}`` of ``DEQUANT_KERNELS`` that a two-pass read
    of each of the ``Compressed`` ``cs`` makes on the card: one launch of
    the epilogue ``compressor._dequantize`` picks for each shape and dtype
    it takes, none for the others."""
    from repro_torch.core.sz import compressor
    from repro_torch.kernels import ops

    want = dict.fromkeys(DEQUANT_KERNELS, 0)
    for c in cs:
        if compressor.reconstruct_unsupported_reason(c.shape,
                                                     c.dtype) is None:
            want[DEQUANT_KERNELS[ops.fused_squeeze(c.shape) is not None]] += 1
    return want


def run_path(name: str, kernels, drive):
    """Zero every launch count, run ``drive()``, read the counts; fail if a
    kernel of the path was not launched or another kernel was.  An
    epilogue of ``DEQUANT_KERNELS`` that the path does not name must
    launch exactly as often as ``dequant_launches`` gives for the payloads
    its two-pass reads dequantized on the card through a backend with the
    op (each recorded as ``compressor._dequantize`` is called).  Returns
    ``(drive(), counts)``."""
    import torch

    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.core.sz import compressor
    from repro_torch.kernels import launches

    read = []
    stock = compressor._dequantize

    def dequantize(c, codes, backend):
        if (codes.device.type == "cuda"
                and hp.get_backend(backend).dequant_fn is not None):
            read.append(c)
        return stock(c, codes, backend)

    launches.reset()
    compressor._dequantize = dequantize
    try:
        out = drive()
        torch.cuda.synchronize()
    finally:
        compressor._dequantize = stock
    counts = launches.counts()
    want = dequant_launches(read)
    print(f"{name} path launches: {json.dumps(counts)}; two-pass reads "
          f"on the card: {len(read)}, epilogues {json.dumps(want)}")
    for kname, n in counts.items():
        if kname in kernels:
            require(n > 0, f"kernel {kname} was not launched on the {name} "
                    f"path")
        elif kname in want:
            require(n == want[kname], f"kernel {kname} was launched {n} "
                    f"times on the {name} path; its two-pass reads take "
                    f"{want[kname]}")
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
            lambda: [compressor._dequantize(c, q, "cuda")
                     for c, q in zip(cs, replay)], 5),
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
    from repro_torch.kernels.cost import HBM_BYTES_PER_S
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
    from repro_torch.kernels.cost import HBM_BYTES_PER_S
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
    from repro_torch.kernels.cost import HBM_BYTES_PER_S
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


def consumer_summary(consumers) -> dict:
    """The checkpoint, fault-campaign, serve and load-generator phases'
    times, in one line."""
    ck, fa, sv, lg, sh = (consumers[k] for k in (
        "checkpoint", "faults", "serve", "loadgen", "sharded"))
    return {
        "checkpoint_save_ms": ck["save_ms"],
        "checkpoint_async_save_ms": ck["async_save_ms"],
        "checkpoint_async_return_ms": ck["async_save_return_ms"],
        "checkpoint_restore_cold_ms": ck["restore_cold_ms"],
        "checkpoint_restore_warm_ms": ck["restore_warm_ms"],
        "checkpoint_step_bytes": ck["step_bytes"],
        "checkpoint_ratio": ck["ratio"],
        "checkpoint_outlier_share": ck["outlier_share"],
        "faults_cases": fa["cases"], "faults_violations": fa["violations"],
        "faults_s": fa["elapsed_s"],
        "serve_wall_s": sv["wall_s"], "serve_kv_err": sv["kv_err"],
        "serve_offload_ratio": sv["offload_ratio"],
        "serve_compress_kv_ratio": sv["compress_kv_ratio"],
        "loadgen": {k: lg[k] for k in (
            "baseline", "scheduler", "scheduler_no_overlap",
            "scheduler_no_overlap_2", "scheduler_2")},
        "sharded_save_ms": sh["save_ms"],
        "sharded_restore_cold_ms": sh["restore_cold_ms"],
        "sharded_restore_warm_ms": sh["restore_warm_ms"],
        "sharded_restore_mesh_ms": sh["restore_mesh_ms"],
        "sharded_restore_mesh_again_ms": sh["restore_mesh_again_ms"],
        "sharded_decode_shards_ms": sh["decode_shards_ms"],
        "sharded_step_bytes": sh["step_bytes"],
        "phase_s": {"checkpoint": ck["phase_s"], "faults": fa["elapsed_s"],
                    "serve": sv["phase_s"], "loadgen": lg["phase_s"],
                    "sharded": sh["phase_s"]}}


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


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _flat_leaves(tree, prefix=""):
    """``{dot-joined path: leaf}`` of a dict tree, as the checkpoint
    manager names its entries."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def run_checkpoint(seed: int) -> dict:
    """The checkpoint manager at full width: qwen3-0.6b's parameters from
    ``init_model`` at ``seed``, stacked into the reference's layout
    (``convert.stack_layers``), saved by ``CheckpointManager`` through a
    "cuda"-encode codec at ``CKPT_EB`` (float32 leaves of at least
    ``CKPT_MIN_SIZE`` values into the step's archive, the rest raw): step 1
    synchronously, step 2 with ``asynchronous=True``; the newest step
    restored cold, then warm; then step 2's manifest torn and a ``skip``
    restore.  One launch check over all of it.  Every compressed leaf is
    within ``eb_effective`` of its original and equals ``decompress_batch``
    of its archive payload bit for bit; raw leaves come back bit for bit;
    the warm restore builds zero plans; the torn restore lands on step 1
    with ``fallback_from`` set.  Prints and returns one ``checkpoint``
    row."""
    import shutil

    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import ARCHIVE_NAME
    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.models import convert
    from repro_torch.models import transformer as T
    from repro_torch.store import Archive

    t_phase = time.perf_counter()
    cfg = configs.get_config("qwen3-0.6b")
    params = convert.stack_layers(T.init_model(seed, cfg, "cuda"))
    flat = _flat_leaves(params)
    n_values = sum(t.numel() for t in flat.values())
    require(n_values == CKPT_VALUES and all(
        t.dtype == torch.float32 for t in flat.values()),
        f"checkpoint: {n_values} parameters, not {CKPT_VALUES} float32")
    directory = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(directory, ignore_errors=True)
    config = CodecConfig(eb=CKPT_EB, encode_backend="cuda")
    reader = Codec(config, plan_cache=PlanCache())
    state = {}

    def drive():
        mgr = CheckpointManager(directory, codec=Codec(
            config, plan_cache=PlanCache()), compress_min_size=CKPT_MIN_SIZE)
        t0 = time.perf_counter()
        mgr.save(1, params)
        state["save_s"] = time.perf_counter() - t0
        amgr = CheckpointManager(directory, codec=Codec(
            config, plan_cache=PlanCache()), compress_min_size=CKPT_MIN_SIZE,
            asynchronous=True)
        t0 = time.perf_counter()
        amgr.save(2, params)
        state["async_return_s"] = time.perf_counter() - t0
        amgr.wait()
        state["async_save_s"] = time.perf_counter() - t0
        rmgr = CheckpointManager(directory, codec=reader)
        for key in ("cold", "warm"):
            reader.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = rmgr.restore()
            torch.cuda.synchronize()
            state[f"restore_{key}_s"] = time.perf_counter() - t0
            state[f"restore_{key}_stats"] = dict(reader.stats)
            state[key] = r
        step2 = os.path.join(directory, "step_00000002")
        state["step_bytes"] = _dir_bytes(step2)
        mpath = os.path.join(step2, "manifest.json")
        with open(mpath, "r+b") as f:
            f.truncate(os.path.getsize(mpath) // 2)
        t0 = time.perf_counter()
        state["torn"] = rmgr.restore(policy="skip")
        torch.cuda.synchronize()
        state["restore_torn_s"] = time.perf_counter() - t0

    _, counts = run_path("checkpoint", CHECKPOINT_KERNELS, drive)
    cold = _flat_leaves(state.pop("cold")["params"])
    warm = _flat_leaves(state["warm"]["params"])
    torn = state["torn"]
    require(state["warm"]["step"] == 2 and not state["warm"]["quarantined"],
            f"checkpoint: restored step {state['warm']['step']}")
    require(torn is not None and torn["step"] == 1
            and [f["step"] for f in torn["fallback_from"]] == [2],
            f"checkpoint: the torn restore landed on "
            f"{torn and torn['step']}, fallback {torn and torn['fallback_from']}")
    torn = _flat_leaves(torn["params"])
    require(state["restore_warm_stats"]["plan_builds"] == 0,
            f"checkpoint: a warm restore built "
            f"{state['restore_warm_stats']['plan_builds']} plans")
    require(sorted(warm) == sorted(flat) == sorted(cold) == sorted(torn),
            "checkpoint: the restored tree's entries differ")
    with open(os.path.join(directory, "step_00000001",
                           "manifest.json")) as f:
        entries = json.load(f)["entries"]
    n_sz = n_outliers = sz_values = 0
    worst = 0.0
    path = os.path.join(directory, "step_00000001", ARCHIVE_NAME)
    with Archive(path, codec=reader) as ar:
        for key, orig in flat.items():
            name = f"params.{key}"
            for tree in (cold, warm, torn):
                require(same(tree[key], warm[key]), f"checkpoint: {name} "
                        f"differs between restores")
            if entries[name]["kind"] == "raw":
                require(same(warm[key], orig), f"checkpoint: raw {name} "
                        f"did not come back bit for bit")
                continue
            c = ar.read_chunk(name)
            want = reader.decompress_batch([c])[0]
            require(same(warm[key], want), f"checkpoint: {name} differs "
                    f"from decompress_batch of its payload")
            err = max_abs_err(warm[key], orig)
            require(err <= c.eb_effective, f"checkpoint: {name} max|x - x'| "
                    f"{err} > eb_effective {c.eb_effective}")
            worst = max(worst, err / c.eb_effective)
            n_sz += 1
            sz_values += orig.numel()
            n_outliers += int((c.outlier_pos >= 0).sum())
            del c, want
    raw_bytes = 4 * n_values
    row = {"arch": cfg.name, "values": n_values, "leaves": len(flat),
           "compressed_leaves": n_sz, "compressed_values": sz_values,
           "eb": CKPT_EB, "compress_min_size": CKPT_MIN_SIZE,
           "launches": counts,
           "save_ms": state["save_s"] * 1e3,
           "async_save_return_ms": state["async_return_s"] * 1e3,
           "async_save_ms": state["async_save_s"] * 1e3,
           "restore_cold_ms": state["restore_cold_s"] * 1e3,
           "restore_warm_ms": state["restore_warm_s"] * 1e3,
           "restore_torn_ms": state["restore_torn_s"] * 1e3,
           "restore_cold_stats": state["restore_cold_stats"],
           "restore_warm_stats": state["restore_warm_stats"],
           "step_bytes": state["step_bytes"], "raw_bytes": raw_bytes,
           "ratio": raw_bytes / state["step_bytes"],
           "outlier_share": n_outliers / max(sz_values, 1),
           "max_err_over_bound": worst,
           "phase_s": time.perf_counter() - t_phase}
    del params, flat, cold, warm, torn, state
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"checkpoint {json.dumps(row)}")
    return row


def run_faults() -> dict:
    """The fault-injection campaign on the card: ``run_campaign(seed=0,
    cases=FAULT_CASES, backend="cuda")``, every decode through the kernels
    (the decode channel hands them corrupt streams, gap arrays, outlier
    lists and tables); zero silent, unnamed or hanging cases.  Prints and
    returns one ``faults`` row."""
    import shutil

    from repro_torch.testing import run_campaign

    directory = os.path.join(ROOT, "build", "chip_smoke_faults")
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.perf_counter()
    report, counts = run_path("faults", FAULT_KERNELS, lambda: run_campaign(
        seed=0, cases=FAULT_CASES, backend="cuda", base_dir=directory))
    elapsed = time.perf_counter() - t0
    print(report.summary())
    require(report.ok, f"faults: {len(report.violations)} violations: "
            f"{[(r.case.kind, r.case.seed, r.outcome, r.note) for r in report.violations[:5]]}")
    outcomes = {}
    for (consumer, outcome), n in sorted(report.counts().items()):
        outcomes.setdefault(consumer, {})[outcome] = n
    row = {"seed": 0, "cases": len(report.results), "backend": "cuda",
           "violations": len(report.violations), "outcomes": outcomes,
           "launches": counts, "elapsed_s": elapsed}
    shutil.rmtree(directory, ignore_errors=True)
    print(f"faults {json.dumps(row)}")
    return row


def run_serve_kv(seed: int) -> dict:
    """``launch.serve.main`` on qwen3-0.6b at full width with its KV paths:
    B 4, a 128-token prompt, 8 generated, ``--kv-offload --kv-block 32``
    (4 blocks) through a "cuda"-encode codec, once with ``--concurrency
    1`` (one batched page-in) and once with 4 (four lanes through the
    serving scheduler); then ``--compress-kv``.  A launch check a run.
    The two offload runs give the same tokens, their ``kv_err`` is within
    the blocks' ``eb_effective`` with the bf16 cast, and the scheduler
    decoded 4 blocks for 16 requests, 12 of them hits or coalesced.
    Prints and returns one ``serve kv`` row."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.launch import serve
    from repro_torch.store import Archive

    t_phase = time.perf_counter()
    directory = os.path.join(ROOT, "build", "chip_smoke_serve")
    shutil.rmtree(directory, ignore_errors=True)
    base = ["--arch", "qwen3-0.6b", "--batch", str(PREFILL_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--gen-len", str(SERVE_GEN),
            "--kv-encode-backend", "cuda", "--seed", str(seed)]
    runs, counts, walls = {}, {}, {}
    for name, extra in (
            ("offload", ["--kv-offload", "--kv-block", str(SERVE_KV_BLOCK),
                         "--concurrency", "1"]),
            ("concurrency", ["--kv-offload", "--kv-block",
                             str(SERVE_KV_BLOCK), "--concurrency",
                             str(SERVE_LANES)]),
            ("compress_kv", ["--compress-kv"])):
        argv = base + extra + ["--kv-offload-dir",
                               os.path.join(directory, name)]
        t0 = time.perf_counter()
        runs[name], counts[name] = run_path(
            f"serve {name}", SERVE_KV_KERNELS, lambda: serve.main(argv))
        walls[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    one, four, ckv = runs["offload"], runs["concurrency"], runs["compress_kv"]
    require(np.array_equal(one["tokens"], four["tokens"]),
            "serve: --concurrency 1 and 4 generated different tokens")
    n_blocks = SERVE_PROMPT // SERVE_KV_BLOCK
    bound = 0.0
    reader = Codec(CodecConfig(), plan_cache=PlanCache())
    block_dir = os.path.join(directory, "offload")
    for f in sorted(os.listdir(block_dir)):
        with Archive(os.path.join(block_dir, f), codec=reader) as ar:
            for name in ar.names:
                c = ar.read_chunk(name)
                bound = max(bound, dataclasses.replace(
                    c, dtype=torch.bfloat16).eb_effective)
    require(len(os.listdir(block_dir)) == n_blocks,
            f"serve: {len(os.listdir(block_dir))} blocks offloaded")
    for r in (one, four):
        require(0 < r["kv_err"] <= bound, f"serve: kv_err {r['kv_err']} "
                f"outside (0, {bound}]")
    st = four["page_stats"]["scheduler"]
    require(st["blocks_decoded"] == n_blocks
            and st["requests"] == SERVE_LANES * n_blocks
            and st["prefix_hits"] + st["coalesced_requests"]
            == (SERVE_LANES - 1) * n_blocks,
            f"serve: scheduler stats {st}")
    require(ckv["ratio"] > 0 and np.isfinite(ckv["kv_err"]),
            f"serve: --compress-kv ratio {ckv['ratio']}, kv_err "
            f"{ckv['kv_err']}")
    row = {"arch": "qwen3-0.6b", "batch": PREFILL_BATCH,
           "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
           "kv_block": SERVE_KV_BLOCK, "blocks": n_blocks,
           "lanes": SERVE_LANES, "launches": counts, "wall_s": walls,
           "kv_err": {"offload": one["kv_err"], "concurrency": four["kv_err"],
                      "compress_kv": ckv["kv_err"], "bound": bound},
           "offload_ratio": one["ratio"], "compress_kv_ratio": ckv["ratio"],
           "scheduler": st, "page_stats": one["page_stats"],
           "phase_s": time.perf_counter() - t_phase}
    shutil.rmtree(directory, ignore_errors=True)
    print(f"serve kv {json.dumps(row)}")
    return row


def run_loadgen(seed: int) -> dict:
    """The serving load generator at qwen3-0.6b's KV shape: ``build_corpus``
    of ``LOAD_SESSIONS`` sessions sharing ``LOAD_PREFIX`` prefix blocks and
    one unique block each, ``LOAD_TOKENS`` tokens a block of 28 layers x 8
    KV heads x 128 ("cuda" encode), then ``run_load`` in the baseline mode,
    the scheduler with overlap and without, then without and with again
    (both orders in one call), at ``LOAD_RATE`` sessions a second, on the
    card (one launch check over the five runs).  The scheduler
    runs hold ``check_invariants``, and every block the scheduler served
    equals ``pager.fetch`` of it bit for bit.  Prints and returns one
    ``loadgen`` row."""
    import shutil
    import threading

    import torch

    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.serving import loadgen
    from repro_torch.store import KVPager

    t_phase = time.perf_counter()
    directory = os.path.join(ROOT, "build", "chip_smoke_loadgen")
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.perf_counter()
    corpus = loadgen.build_corpus(
        directory, n_sessions=LOAD_SESSIONS, prefix_blocks=LOAD_PREFIX,
        unique_blocks=1, tokens_per_block=LOAD_TOKENS, layers=28, heads=8,
        head_dim=128, seed=seed, config=CodecConfig(encode_backend="cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    served: dict = {}
    lock = threading.Lock()

    class Recording(loadgen.DecodeScheduler):
        """The scheduler, keeping what each fetch returned."""

        def fetch(self, sid, block_ids):
            out = super().fetch(sid, block_ids)
            with lock:
                for bid, tensors in out.items():
                    served.setdefault(bid, []).append(tensors)
            return out

    runs = {}

    def drive():
        runs["baseline"] = loadgen.run_load(
            corpus, mode="baseline", rate_per_s=LOAD_RATE, seed=seed)
        original = loadgen.DecodeScheduler
        loadgen.DecodeScheduler = Recording
        try:
            # Overlap on, off, then off and on again: the two modes in both
            # orders within one call.
            for key, overlap in (("scheduler", True),
                                 ("scheduler_no_overlap", False),
                                 ("scheduler_no_overlap_2", False),
                                 ("scheduler_2", True)):
                runs[key] = loadgen.run_load(
                    corpus, mode="scheduler", rate_per_s=LOAD_RATE,
                    seed=seed, overlap=overlap)
        finally:
            loadgen.DecodeScheduler = original

    _, counts = run_path("loadgen", LOADGEN_KERNELS, drive)
    for key in ("scheduler", "scheduler_no_overlap",
                "scheduler_no_overlap_2", "scheduler_2"):
        loadgen.check_invariants(corpus, runs["baseline"], runs[key])
    pager = KVPager(corpus.dir, codec=Codec(corpus.config,
                                            plan_cache=PlanCache()))
    for bid, meta in corpus.metas.items():
        pager.adopt_block(bid, meta)
    require(sorted(served) == sorted(corpus.metas),
            f"loadgen: the scheduler served {len(served)} of "
            f"{len(corpus.metas)} blocks")
    n_checked = 0
    for bid, outs in served.items():
        want = pager.fetch(bid)
        for got in outs:
            for name, t in want.items():
                require(same(got[name], t), f"loadgen: block {bid} {name} "
                        f"served differs from pager.fetch")
                n_checked += 1
    raw = sum(t.numel() * 4 for t in want.values())
    row = {"sessions": LOAD_SESSIONS, "prefix_blocks": LOAD_PREFIX,
           "tokens_per_block": LOAD_TOKENS,
           "block_shape": list(next(iter(want.values())).shape),
           "distinct_blocks": corpus.n_distinct_blocks,
           "block_requests": corpus.n_block_requests,
           "raw_bytes": raw * corpus.n_distinct_blocks,
           "rate_per_s": LOAD_RATE, "build_s": build_s,
           "launches": counts, "served_tensors_checked": n_checked,
           "phase_s": time.perf_counter() - t_phase}
    for key, r in runs.items():
        row[key] = {"p50_ttft_ms": r["ttft"]["p50_ms"],
                    "p99_ttft_ms": r["ttft"]["p99_ms"],
                    "dispatches_per_request": r["dispatches_per_request"],
                    "decode_dispatches": r["decode_dispatches"],
                    "wall_s": r["wall_s"], **({"scheduler": r["scheduler"]}
                                              if "scheduler" in r else {})}
    del served, runs, pager
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"loadgen {json.dumps(row)}")
    return row


def run_sharded(seed: int) -> dict:
    """The mesh-sharded checkpoint at full width: qwen3-0.6b's parameters
    (``init_model`` at ``seed``, stacked by ``convert.stack_layers``) saved
    by ``CheckpointManager`` through a "cuda"-encode codec at ``CKPT_EB``
    on the reference's ``SHARD_LAYOUT`` in ``SHARD_COUNT`` shards
    (``SHARD_TILES`` tiles); restored cold and warm with no mesh (full
    tensors on the card), then into ``make_host_mesh()`` (DTensors); one
    host's share decoded alone (``ShardedRestorer.decode_shards([0])``).
    One launch check over that, another over the salvage: shard 1
    overwritten by 4 KiB in its middle, restored under "raise" and
    "zero_fill".  Gates: every tile equals ``decompress_batch`` of its
    shard chunk bit for bit and is within that chunk's ``eb_effective``
    of the original; raw leaves bit for bit; the warm restore builds no
    plan; each DTensor's ``to_local()`` equals the full restore; "raise"
    names the shard file, "zero_fill" quarantines exactly the entries of
    the chunks the store's own CRC check rejects, zeros for them, every
    other entry intact.  Then ``make_dp_gradient_sync`` on a
    ``GRAD_SHAPE`` gradient over the one-rank NCCL group, bit for bit
    against the same call over a one-rank gloo group on the CPU.  Prints
    and returns one ``sharded`` row."""
    import shutil
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import CheckpointIntegrityError
    from repro_torch.core.cache import PlanCache
    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.distributed import (ShardedRestorer, load_manifest,
                                         tile_slice)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import convert
    from repro_torch.models import transformer as T
    from repro_torch.runtime import collectives
    from repro_torch.store import Archive, StoreError

    t_phase = time.perf_counter()
    cfg = configs.get_config("qwen3-0.6b")
    params = convert.stack_layers(T.init_model(seed, cfg, "cuda"))
    flat = _flat_leaves(params)
    n_values = sum(t.numel() for t in flat.values())
    require(n_values == CKPT_VALUES, f"sharded: {n_values} parameters")
    directory = os.path.join(ROOT, "build", "chip_smoke_sharded")
    step = os.path.join(directory, "step_00000001")
    shutil.rmtree(directory, ignore_errors=True)
    layout = SimpleNamespace(shape=dict(SHARD_LAYOUT),
                             axis_names=tuple(SHARD_LAYOUT))
    config = CodecConfig(eb=CKPT_EB, encode_backend="cuda")
    reader = Codec(config, plan_cache=PlanCache())
    state = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        state[key] = time.perf_counter() - t0
        return out

    def drive():
        mgr = CheckpointManager(directory, codec=Codec(
            config, plan_cache=PlanCache()), compress_min_size=CKPT_MIN_SIZE)
        timed("save_s", lambda: mgr.save(1, params, mesh=layout,
                                         shard_count=SHARD_COUNT))
        rmgr = CheckpointManager(directory, codec=reader)
        for key in ("cold", "warm"):
            reader.reset_stats()
            state[key] = timed(f"restore_{key}_s", rmgr.restore)
            state[f"restore_{key}_stats"] = dict(reader.stats)
        state["mesh"] = make_host_mesh()
        reader.reset_stats()
        state["on_mesh"] = timed("restore_mesh_s", lambda: rmgr.restore(
            mesh=state["mesh"]))
        state["restore_mesh_stats"] = dict(reader.stats)
        # The first DTensor of a process imports torch._dynamo (seconds,
        # once): a second restore into the mesh reads without it.
        timed("restore_mesh_again_s", lambda: rmgr.restore(
            mesh=state["mesh"]))
        restorer = ShardedRestorer(step, codec=reader)
        state["share"] = timed("decode_shards_s",
                               lambda: restorer.decode_shards([0]))

    _, counts = run_path("sharded", SHARDED_KERNELS, drive)
    manifest = load_manifest(step)
    with open(os.path.join(step, "manifest.json")) as f:
        kinds = {k: e["kind"] for k, e in json.load(f)["entries"].items()}
    n_tiles = sum(len(e["tiles"]) for e in manifest["entries"].values())
    require(n_tiles == SHARD_TILES, f"sharded: {n_tiles} tiles, not "
            f"{SHARD_TILES}")
    require(sorted(kinds.values()).count("sz-sharded") == 8
            and sorted(kinds.values()).count("raw") == 5,
            f"sharded: entry kinds {kinds}")
    cold = _flat_leaves(state.pop("cold")["params"])
    warm = _flat_leaves(state.pop("warm")["params"])
    on_mesh = _flat_leaves(state.pop("on_mesh")["params"])
    require(sorted(cold) == sorted(warm) == sorted(on_mesh) == sorted(flat),
            "sharded: the restored trees' entries differ")
    require(state["restore_warm_stats"]["plan_builds"] == 0
            and state["restore_mesh_stats"]["plan_builds"] == 0,
            f"sharded: a warm restore built plans: "
            f"{state['restore_warm_stats']['plan_builds']}, "
            f"{state['restore_mesh_stats']['plan_builds']}")
    for key, orig in flat.items():
        leaf = on_mesh[key]
        require(isinstance(leaf, DTensor) and same(leaf.to_local(),
                                                   cold[key])
                and same(warm[key], cold[key]),
                f"sharded: params.{key} differs between restores")
        if kinds[f"params.{key}"] == "raw":
            require(same(cold[key], orig), f"sharded: raw params.{key} did "
                    f"not come back bit for bit")
    del on_mesh, warm
    worst = 0.0
    shard_of = {}
    n_outliers = 0
    for name, meta in manifest["entries"].items():
        key = name.partition(".")[2]
        for t in meta["tiles"]:
            shard_of[t["chunk"]] = (int(t["shard"]), name)
            sl = tile_slice(t["offset"], t["shape"])
            path = os.path.join(step, f"shard_{int(t['shard']):05d}.szt")
            with Archive(path, codec=reader) as ar:
                c = ar.read_chunk(t["chunk"])
            want = reader.decompress_batch([c])[0]
            got = cold[key][sl]
            require(same(got, want), f"sharded: tile {t['chunk']} differs "
                    f"from decompress_batch of its chunk")
            err = max_abs_err(got, flat[key][sl])
            require(err <= c.eb_effective, f"sharded: tile {t['chunk']} "
                    f"max|x - x'| {err} > eb_effective {c.eb_effective}")
            worst = max(worst, err / c.eb_effective)
            n_outliers += int((c.outlier_pos >= 0).sum())
            del c, want
    share = state.pop("share")
    require(sorted(share) == sorted(c for c, (s, _) in shard_of.items()
                                    if s == 0),
            "sharded: decode_shards([0]) decoded other chunks")
    for chunk, t in share.items():
        name = shard_of[chunk][1]
        meta = next(m for m in manifest["entries"][name]["tiles"]
                    if m["chunk"] == chunk)
        require(same(t, cold[name.partition(".")[2]][
            tile_slice(meta["offset"], meta["shape"])]),
            f"sharded: decode_shards tile {chunk} differs")
    share_values = sum(t.numel() for t in share.values())
    del share
    step_bytes = _dir_bytes(step)
    shard_bytes = {f: os.path.getsize(os.path.join(step, f))
                   for f in sorted(os.listdir(step)) if f.endswith(".szt")}

    # -- salvage: 4 KiB of shard 1 overwritten in its middle ---------------
    spath = os.path.join(step, "shard_00001.szt")
    with open(spath, "r+b") as f:
        f.seek(os.path.getsize(spath) // 2)
        f.write(b"\xff" * 4096)
    rejected = set()
    with Archive(spath, codec=reader) as ar:
        for chunk in ar.names:
            try:
                ar.read_chunk(chunk)
            except StoreError:
                rejected.add(shard_of[chunk][1])

    def salvage():
        smgr = CheckpointManager(directory, codec=reader)
        try:
            smgr.restore(policy="raise")
            state["raise"] = None
        except CheckpointIntegrityError as e:
            state["raise"] = str(e)
        state["zero"] = timed("salvage_s", lambda: smgr.restore(
            policy="zero_fill"))

    _, salvage_counts = run_path("sharded salvage", SALVAGE_KERNELS,
                                 salvage)
    zero = state.pop("zero")
    quarantined = sorted(zero["quarantined"])
    require(state["raise"] is not None and "shard_00001.szt" in
            state["raise"], f"sharded: restore(policy='raise') gave "
            f"{state['raise']!r}")
    require(rejected and quarantined == sorted(rejected),
            f"sharded: quarantined {quarantined}, the store rejects "
            f"chunks of {sorted(rejected)}")
    require(all("shard_00001.szt" in why
                for why in zero["quarantined"].values()),
            "sharded: a quarantine reason does not name shard_00001.szt")
    zleaves = _flat_leaves(zero["params"])
    for key in flat:
        if f"params.{key}" in rejected:
            require(not bool(zleaves[key].any()), f"sharded: quarantined "
                    f"params.{key} is not zeros")
        else:
            require(same(zleaves[key], cold[key]), f"sharded: params.{key}"
                    f" outside the quarantine changed")
    del zero, zleaves, cold
    shutil.rmtree(directory, ignore_errors=True)

    # -- the compressed gradient sync: NCCL on the card, gloo on the CPU ---
    g = torch.randn(GRAD_SHAPE, generator=torch.Generator().manual_seed(
        seed)) * 1e-3
    grads = {"w": g.cuda()}
    sync, init = collectives.make_dp_gradient_sync(state.pop("mesh"),
                                                   eb=GRAD_EB)
    res0 = init(grads)
    timed("sync_first_s", lambda: sync(grads, res0))
    out, res = timed("sync_s", lambda: sync(grads, res0))
    csync, cinit = collectives.make_dp_gradient_sync(
        make_host_mesh(device_type="cpu"), eb=GRAD_EB)
    t0 = time.perf_counter()
    cout, cres = csync({"w": g}, cinit({"w": g}))
    state["cpu_sync_s"] = time.perf_counter() - t0
    a, b = out["w"].cpu(), cout["w"]
    diff = (bits(a) != bits(b)).nonzero()
    require(len(diff) == 0 and same(res["w"].cpu(), cres["w"]),
            f"sharded: the NCCL and gloo syncs differ at {len(diff)} "
            f"values, first {diff[:4].tolist()}: "
            f"{[float(a[tuple(i)]) for i in diff[:4]]} against "
            f"{[float(b[tuple(i)]) for i in diff[:4]]}")
    sync_err = max_abs_err(a, g)
    del g, grads, out, res, cout, cres, a, b, res0
    dist.destroy_process_group()

    raw_bytes = 4 * n_values
    row = {"arch": cfg.name, "layout": SHARD_LAYOUT, "shards": SHARD_COUNT,
           "tiles": n_tiles,
           "sharded_entries": sorted(kinds.values()).count("sz-sharded"),
           "raw_entries": sorted(kinds.values()).count("raw"),
           "eb": CKPT_EB, "launches": counts,
           "salvage_launches": salvage_counts,
           "save_ms": state["save_s"] * 1e3,
           "restore_cold_ms": state["restore_cold_s"] * 1e3,
           "restore_warm_ms": state["restore_warm_s"] * 1e3,
           "restore_mesh_ms": state["restore_mesh_s"] * 1e3,
           "restore_mesh_again_ms": state["restore_mesh_again_s"] * 1e3,
           "restore_cold_stats": state["restore_cold_stats"],
           "restore_warm_stats": state["restore_warm_stats"],
           "decode_shards_ms": state["decode_shards_s"] * 1e3,
           "decode_shards_values": share_values,
           "step_bytes": step_bytes, "shard_bytes": shard_bytes,
           "raw_bytes": raw_bytes, "ratio": raw_bytes / step_bytes,
           "outlier_share": n_outliers / CKPT_VALUES,
           "max_err_over_bound": worst,
           "salvage_ms": state["salvage_s"] * 1e3,
           "quarantined": quarantined,
           "grad_sync": {"shape": list(GRAD_SHAPE), "eb": GRAD_EB,
                         "nccl_first_ms": state["sync_first_s"] * 1e3,
                         "nccl_ms": state["sync_s"] * 1e3,
                         "gloo_cpu_ms": state["cpu_sync_s"] * 1e3,
                         "bit_equal": True, "max_abs_err": sync_err},
           "torch": torch.__version__,
           "phase_s": time.perf_counter() - t_phase}
    del params, flat, state
    torch.cuda.empty_cache()
    print(f"sharded {json.dumps(row)}")
    return row


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def first_kernel_inputs(cfg, params, tokens):
    """The inputs the prefill forward gives its first kernel launch, made
    by the port's own functions: layer 0's attention (q, k, v) for the
    dense family, its recurrence's (r, k, v, w, u, state) for rwkv, and
    for hybrid_ssm the shared block's (q, k, v) at its first invocation,
    after the SSM layers 0 .. ``hybrid_attn_every`` - 1."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv as R
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        x = params["embed"][tokens].to(cfg.cdt)
        lp = params["layers"][0]
        if cfg.family == "hybrid_ssm":
            for ssm_lp in params["layers"][:cfg.hybrid_attn_every]:
                x = T._ssm_layer(x, ssm_lp, cfg)
            lp = params["shared_attn"]
        xn = L.rms_norm(x, lp["ln1"])
        if cfg.family in ("dense", "hybrid_ssm"):
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
        q, k, v, kw = args
        got = [FA.flash_attention(q, k, v, **kw)]
        want = [FA.flash_attention_plain(q, k, v, **kw)]
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
    import io
    import re

    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import cost
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
                    "flash_attention", (q, k, v, KC.flash_kwargs(case)),
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
        args = first_kernel_inputs(cfg, params, tokens)
        if kname == "flash_attention":
            q, k, v = args
            err = check_model_kernel(
                kname, (q, k, v, {"causal": True, "scale": 1.0}),
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
            dbound, _ = cost.model_kernel_bound(kname, dargs,
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
        entry["bound_ms"], entry["bound_by"] = cost.model_kernel_bound(
            kname, kargs, outs)
        entry["max_abs_err"] = max(err, case_errs[kname])
        entry["shape"] = [list(t.shape) for t in kargs if t is not None]
        entry["dtype"] = _dtype_name(kargs[0])
        entry["launches"] = counts[kname]
        del args, kargs, outs
        if kname == "flash_attention":
            del q, k, v, q4, k4, v4, out

        # step decode against the forward, float32, B 2, 256 tokens
        toks = torch.randint(0, cfg.vocab, (CONSIST_BATCH, CONSIST_LEN),
                             generator=gen, device="cuda")
        t0 = time.perf_counter()
        row["decode_vs_forward_f32"] = decode_against_forward(
            cfg, params, toks, arch)
        torch.cuda.synchronize()
        row["decode_check_f32_s"] = time.perf_counter() - t0
        # one bf16 serve step at the serve phase's shape (B 4, a 64-slot
        # cache), as serve.main runs it
        scache = D.init_cache(cfg, 4, 64, "cuda")
        stok = toks[:, :1].repeat(2, 1)
        row["serve_step_profile"] = profile_breakdown(
            lambda: St.make_serve_step(cfg)(params, stok, scache, 40))
        del scache, params
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


def check_flash_at(q, k, v, kw, stage: str) -> dict:
    """``flash_attention`` at one of a path's shapes: the kernel against
    its plain version (``check_model_kernel``), its time, its bound from
    the pairs its mask keeps, and its inputs' shapes."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attn as FA

    err = check_model_kernel("flash_attention", (q, k, v, kw), stage)
    out = FA.flash_attention(q, k, v, **kw)
    bound, by = cost.model_kernel_bound("flash_attention", (q, k, v),
                                        (out,), kw)
    return {"shape": [list(t.shape) for t in (q, k, v)],
            "dtype": _dtype_name(q), **kw,
            "max_abs_err": err, "bound_ms": bound, "bound_by": by,
            "ms": cuda_ms(lambda: FA.flash_attention(q, k, v, **kw), 10)}


def decode_against_forward(cfg, params, tokens, stage: str, frames=None):
    """float32 step decode of ``tokens`` (B, S) against the forward's
    logits at every position, within ``DECODE_F32_TOL`` with equal argmax
    wherever the top-2 gap exceeds it; encdec's cross entries from
    ``frames`` through its encoder.  Returns the check's row."""
    import dataclasses

    import torch

    from repro_torch.models import decode as D
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    b, n = tokens.shape
    full = St.make_prefill_step(cfg32)(params, tokens, frames)
    cache = D.init_cache(cfg32, b, n, "cuda")
    if frames is not None:
        with torch.inference_mode():
            cache.update(D.cross_cache(params, T.encode(params, frames,
                                                        cfg32), cfg32))
    step = St.make_serve_step(cfg32)
    steps = []
    for t in range(n):
        lg, cache = step(params, tokens[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
    stepped = torch.stack(steps, 1)
    diff = float((stepped - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > DECODE_F32_TOL
    agree = stepped.argmax(-1) == full.argmax(-1)
    require(diff <= DECODE_F32_TOL, f"{stage}: step decode differs from "
            f"the forward by {diff} > {DECODE_F32_TOL} (float32)")
    require(bool(agree[clear].all()), f"{stage}: step decode's argmax "
            f"differs from the forward's where the top-2 gap exceeds "
            f"{DECODE_F32_TOL}")
    return {"max_abs_diff": diff, "tol": DECODE_F32_TOL,
            "logit_scale": float(full.abs().max()),
            "positions": int(clear.numel()), "clear_top2": int(clear.sum()),
            "argmax_agree": int(agree.sum())}


def serve_row(arch: str, argv, kernels, seed: int) -> tuple:
    """``launch.serve.main`` of ``arch`` at B 4, 32 + 32 with ``argv``
    added, counts zeroed just before and read just after: (its row, its
    launch counts)."""
    import contextlib
    import io
    import re

    from repro_torch.launch import serve

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        served, counts = run_path(f"{arch} serve", kernels, lambda: serve.main(
            ["--arch", arch, "--batch", "4", "--prompt-len", "32",
             "--gen-len", "32", "--seed", str(seed), *argv]))
    print(printed.getvalue(), end="")
    require(served["tokens"].shape == (4, 33),
            f"{arch}: serve tokens {served['tokens'].shape}")
    m = re.search(r"prefill \d+ toks in ([\d.]+)s; generated (\d+) "
                  r"tokens in ([\d.]+)s \(([\d.]+) tok/s\)",
                  printed.getvalue())
    require(m is not None, f"{arch}: serve printed no summary")
    return {"argv": list(argv), "prefill_32_steps_s": float(m.group(1)),
            "generated": int(m.group(2)), "gen_s": float(m.group(3)),
            "tok_per_s": float(m.group(4)), "kv_err": served["kv_err"],
            "ratio": served["ratio"],
            "launches": {k: v for k, v in counts.items() if v}}, counts


def run_families(seed: int) -> dict:
    """The attention-families phase (slice 18): h2o-danube-1.8b (the
    sliding window), whisper-base (encoder, decoder, cross-attention) and
    qwen2-vl-72b (M-RoPE, patch stubs; full width, ``VLM_LAYERS`` of its
    80 layers) on the card with weights from ``seed``, each path with its
    own launch check.  A family's prefill (``make_prefill_step``) launches
    ``flash_attention`` once an attention: danube 24 windowed launches,
    whisper 18 (6 encoder, non-causal; 6 decoder self; 6 cross, Sq 448
    over Skv 1,500), qwen2-vl 8.  The kernel against its plain version at
    each path's layer-0 inputs (danube's beside its bound from the pairs
    inside the window and SDPA with the equivalent boolean mask, the
    yardstick); float32 step decode against the forward a family;
    ``serve.main`` of danube and of whisper (``--compress-kv`` through a
    "cuda"-encode codec, its cross K/V from zero frames); the reduced
    danube's ring buffer past its wrap, the card against the CPU;
    qwen3-0.6b's int8 KV cache against its bf16 one; one reduced train
    step of whisper-base and danube on the card against the CPU.  Prints
    and returns one ``families`` row."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.models import attention as A
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    row = {}
    gen = T.generator(seed + 2, "cuda")

    def tokens_of(cfg, b, n):
        return torch.randint(0, cfg.vocab, (b, n), generator=gen,
                             device="cuda")

    def prefill(arch, cfg, params, tokens, extra, want):
        step = St.make_prefill_step(cfg)
        logits, counts = run_path(f"{arch} prefill", ("flash_attention",),
                                  lambda: step(params, tokens, extra))
        n = counts["flash_attention"]
        require(n == want, f"{arch}: {n} flash_attention launches in the "
                f"prefill, not {want}")
        s_total = tokens.shape[1] + (extra.shape[1] if cfg.family == "vlm"
                                     else 0)
        require(tuple(logits.shape) == (tokens.shape[0], s_total, cfg.vocab)
                and logits.dtype == torch.bfloat16
                and bool(torch.isfinite(logits).all()),
                f"{arch}: prefill logits {logits.dtype}{list(logits.shape)}")
        del logits
        ms = cuda_ms(lambda: step(params, tokens, extra), 2)
        return {"prefill_launches": n, "prefill_shape": [
                    tokens.shape[0], s_total], "prefill_ms": ms,
                "prefill_tok_per_s": tokens.numel() / (ms * 1e-3)}

    def sizes(params):
        leaves = list(_leaves(params))
        return {"params": sum(t.numel() for t in leaves),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in leaves)}

    def layer_qkv(cfg, lp, x, positions, kv_x=None, ln="ln1", key="attn"):
        with torch.inference_mode():
            return A.attn_kernel_inputs(*A._project_qkv(
                L.rms_norm(x, lp[ln]), lp[key], cfg, positions, kv_x=kv_x))

    # -- h2o-danube-1.8b: 24 layers, the window at 4,096 of 8,192 ---------
    arch = "h2o-danube-1.8b"
    cfg = configs.get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, cfg, "cuda")
    r = {**sizes(params), "window": cfg.swa_window}
    tokens = tokens_of(cfg, DANUBE_BATCH, DANUBE_LEN)
    r.update(prefill(arch, cfg, params, tokens, None, cfg.n_layers))
    x = params["embed"][tokens].to(cfg.cdt)
    q, k, v = layer_qkv(cfg, params["layers"][0], x, torch.arange(
        DANUBE_LEN, dtype=torch.int32, device="cuda"))
    kw = {"causal": True, "scale": 1.0, "window": cfg.swa_window}
    win = check_flash_at(q, k, v, kw, f"{arch} layer 0")
    win["plain_ms"] = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                              1)
    b, s = DANUBE_BATCH, DANUBE_LEN
    q4, k4, v4 = (t.view(b, t.shape[0] // b, s, t.shape[-1])
                  for t in (q, k, v))
    mask = FA.visible_mask(s, s, causal=True, window=cfg.swa_window,
                           device="cuda")

    def library():
        return F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=True)

    out = FA.flash_attention(q, k, v, **kw)
    win["library_max_abs_err"] = max_abs_err(library().reshape(out.shape),
                                             out)
    win["library_ms"] = cuda_ms(library, 5)
    win["library_call"] = ("F.scaled_dot_product_attention(q, k, v, "
                           "attn_mask=<bool (S, S) window mask>, scale=1.0, "
                           "enable_gqa=True)")
    win["no_window_ms"] = cuda_ms(lambda: FA.flash_attention(
        q, k, v, causal=True, scale=1.0), 10)
    win["pairs"] = cost.flash_pairs(s, s, True, cfg.swa_window)
    win["causal_pairs"] = cost.flash_pairs(s, s, True)
    r["layer0_kernel"] = win
    del q, k, v, q4, k4, v4, mask, out, x
    r["decode_vs_forward_f32"] = decode_against_forward(
        cfg, params, tokens_of(cfg, 1, FAMILY_DECODE_LEN), arch)
    del params
    torch.cuda.empty_cache()
    r["serve"], _ = serve_row(arch, [], (), seed)
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row[arch] = r
    torch.cuda.empty_cache()

    # -- whisper-base: encoder 1,500 frames, decoder 448 tokens ----------
    arch = "whisper-base"
    cfg = configs.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, cfg, "cuda")
    r = sizes(params)
    frames = torch.randn((WHISPER_BATCH, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device="cuda")
    tokens = tokens_of(cfg, WHISPER_BATCH, WHISPER_LEN)
    want = cfg.encoder_layers + 2 * cfg.n_layers
    r.update(prefill(arch, cfg, params, tokens, frames, want))
    enc_in = frames.to(cfg.cdt)
    pos_e = torch.arange(cfg.encoder_seq, dtype=torch.int32, device="cuda")
    pos_d = torch.arange(WHISPER_LEN, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        enc = T.encode(params, frames, cfg)
    x = params["embed"][tokens].to(cfg.cdt)
    lp = params["layers"][0]
    r["layer0_kernel"] = {
        name: check_flash_at(*qkv, {"causal": causal, "scale": 1.0},
                             f"{arch} {name} layer 0")
        for name, qkv, causal in (
            ("encoder", layer_qkv(cfg, params["encoder"][0], enc_in, pos_e),
             False),
            ("self", layer_qkv(cfg, lp, x, pos_d), True),
            ("cross", layer_qkv(cfg, lp, x, None, kv_x=enc, ln="ln_x",
                                key="xattn"), False))}
    del enc, x, enc_in
    r["decode_vs_forward_f32"] = decode_against_forward(
        cfg, params, tokens_of(cfg, 1, FAMILY_DECODE_LEN), arch,
        frames=frames[:1])
    del params, frames
    torch.cuda.empty_cache()
    r["serve"], scounts = serve_row(
        arch, ["--compress-kv", "--kv-encode-backend", "cuda"],
        SERVE_KV_KERNELS, seed)
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row[arch] = r
    torch.cuda.empty_cache()

    # -- qwen2-vl-72b at full width, 8 of its 80 layers ------------------
    arch = "qwen2-vl-72b"
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=VLM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, cfg, "cuda")
    r = {**sizes(params), "layers": VLM_LAYERS,
         "cut": f"n_layers 80 -> {VLM_LAYERS}: the 80 layers hold ~145 GB "
                f"of bf16 weights, past one card's 80 GB"}
    patches = torch.randn((VLM_BATCH, VLM_PATCHES, cfg.d_model),
                          generator=gen, device="cuda") * 0.02
    tokens = tokens_of(cfg, VLM_BATCH, VLM_LEN)
    r.update(prefill(arch, cfg, params, tokens, patches, cfg.n_layers))
    x = torch.cat([patches.to(cfg.cdt), params["embed"][tokens].to(cfg.cdt)],
                  dim=1)
    r["layer0_kernel"] = check_flash_at(
        *layer_qkv(cfg, params["layers"][0], x,
                   T._positions(cfg, x.shape[1], "cuda")),
        {"causal": True, "scale": 1.0}, f"{arch} layer 0")
    del x, patches
    r["decode_vs_forward_f32"] = decode_against_forward(
        cfg, params, tokens_of(cfg, 1, FAMILY_DECODE_LEN), arch)
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    row[arch] = r
    torch.cuda.empty_cache()

    # -- the reduced danube's ring buffer past its wrap, card vs CPU ----
    rcfg = configs.get_config("h2o-danube-1.8b").reduced(
        compute_dtype="float32")
    cpu = T.init_model(seed, rcfg, "cpu")
    card = St.adamw.tree_map(lambda t: t.cuda(), cpu)
    toks = torch.randint(0, rcfg.vocab, (2, WRAP_STEPS),
                         generator=torch.Generator().manual_seed(seed))
    caches = [D.init_cache(rcfg, 2, 2 * WRAP_STEPS, dev)
              for dev in ("cpu", "cuda")]
    step = St.make_serve_step(rcfg)
    wrap_err = 0.0
    for t in range(WRAP_STEPS):
        a, caches[0] = step(cpu, toks[:, t:t + 1], caches[0], t)
        g, caches[1] = step(card, toks[:, t:t + 1].cuda(), caches[1], t)
        wrap_err = max(wrap_err, max_abs_err(g.cpu(), a))
    cache_err = max(max_abs_err(caches[1][n].cpu(), caches[0][n])
                    for n in caches[0])
    require(caches[0]["k"].shape[2] == rcfg.swa_window
            and wrap_err <= 1e-4 and cache_err <= 1e-4,
            f"reduced danube wrap: card against CPU logits {wrap_err}, "
            f"cache {cache_err}")
    row["danube_wrap"] = {"window": rcfg.swa_window, "steps": WRAP_STEPS,
                          "max_logit_err": wrap_err,
                          "max_cache_err": cache_err, "tol": 1e-4}
    del cpu, card, caches

    # -- qwen3-0.6b's int8 KV cache against its bf16 one ------------------
    qcfg = configs.get_config("qwen3-0.6b")
    qq = dataclasses.replace(qcfg, kv_quant=True)
    params = T.init_model(seed, qcfg, "cuda")
    toks = tokens_of(qcfg, INT8_BATCH, INT8_STEPS)

    def decode(cfg):
        cache = D.init_cache(cfg, INT8_BATCH, INT8_STEPS, "cuda")
        step = St.make_serve_step(cfg)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(INT8_STEPS):
            lg, cache = step(params, toks[:, t:t + 1], cache, t)
            out.append(lg[:, 0].float())
        torch.cuda.synchronize()
        return torch.stack(out, 1), cache, time.perf_counter() - t0

    (a, ca, _), _ = run_path("qwen3 bf16 kv decode", (),
                             lambda: decode(qcfg))
    (b_, cb, _), _ = run_path("qwen3 int8 kv decode", (), lambda: decode(qq))
    require(cb["k"].dtype == torch.int8 and cb["k_scale"].dtype
            == torch.float32, "qwen3 int8 cache dtypes")
    diff = float((a - b_).abs().max())
    top2 = a.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > INT8_TOL
    agree = a.argmax(-1) == b_.argmax(-1)
    require(diff < INT8_TOL and bool(agree[clear].all()),
            f"qwen3 int8 KV decode differs from the bf16 cache's by {diff} "
            f"(tol {INT8_TOL}) or in argmax where the top-2 gap exceeds it")
    times = {name: [decode(c)[2] for _ in range(2)][-1]
             for name, c in (("bf16", qcfg), ("int8", qq))}
    row["int8_kv"] = {
        "arch": "qwen3-0.6b", "batch": INT8_BATCH, "steps": INT8_STEPS,
        "max_abs_diff": diff, "tol": INT8_TOL,
        "positions": int(clear.numel()), "clear_top2": int(clear.sum()),
        "argmax_agree": int(agree.sum()),
        "cache_bytes": {"bf16": sum(t.numel() * t.element_size()
                                    for t in ca.values()),
                        "int8": sum(t.numel() * t.element_size()
                                    for t in cb.values())},
        "tok_per_s": {n: INT8_BATCH * INT8_STEPS / t_
                      for n, t_ in times.items()}}
    del params, ca, cb, a, b_
    torch.cuda.empty_cache()

    # -- one reduced train step, the card against the CPU ----------------
    row["train_card_vs_cpu"] = {
        arch: check_train_step(arch, seed)
        for arch in ("whisper-base", "h2o-danube-1.8b")}
    row["launches"] = {arch: row[arch]["prefill_launches"]
                       for arch in FAMILY_ARCHS}
    row["serve_launches"] = {arch: row[arch]["serve"]["launches"]
                             for arch in ("h2o-danube-1.8b",
                                          "whisper-base")}
    row["phase_s"] = time.perf_counter() - t_phase
    print(f"families {json.dumps(row)}")
    return row


def check_moe_block(seed: int) -> dict:
    """``moe_block`` of the reduced qwen2-moe (float32) at capacity factor
    ``MOE_DROP_CF``, where assignments drop, on the card and on the CPU
    from the same weights and inputs: out within 1e-5 of its scale, aux
    within 1e-6 relative, the card's out the same on a second call; then
    ``route`` on the card, fed the CPU's logits, gives the CPU's integer
    outputs (topi, ranks, keep, tok_ids, assign) exactly.  Fails if a
    token's k-th and (k+1)-th gates lie within ``MOE_TIE_GAP``."""
    import torch

    from repro_torch import configs
    from repro_torch.models import moe as MOE
    from repro_torch.optim import adamw as O

    cfg = configs.get_config(MOE_ARCH).reduced(compute_dtype="float32",
                                               capacity_factor=MOE_DROP_CF)
    cpu = MOE.init_moe(torch.Generator().manual_seed(seed), cfg)
    card = O.tree_map(lambda t: t.cuda(), cpu)
    x = torch.randn((TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    logits = x.reshape(-1, cfg.d_model) @ cpu["router"]
    top = torch.softmax(logits.double(), -1).sort(-1, descending=True)[0]
    gap = float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min())
    require(gap > MOE_TIE_GAP, f"moe_block check: a token's gates lie "
            f"{gap} apart at the top-k boundary")
    want, want_aux = MOE.moe_block(x, cpu, cfg)
    got, aux = MOE.moe_block(x.cuda(), card, cfg)
    again, _ = MOE.moe_block(x.cuda(), card, cfg)
    scale = max(1.0, float(want.abs().max()))
    err = max_abs_err(got.cpu(), want)
    aux_err = abs(float(aux) - float(want_aux)) / float(want_aux)
    require(err <= 1e-5 * scale and aux_err <= 1e-6
            and bool(torch.equal(got, again)),
            f"moe_block on the card against the CPU: out {err} (scale "
            f"{scale}), aux {aux_err} relative, or a second call differs")
    rc, rg = MOE.route(logits, cfg), MOE.route(logits.cuda(), cfg)
    names = ("topi", "rank", "keep", "tok_ids", "assign")
    require(all(torch.equal(getattr(rg, n).cpu(), getattr(rc, n))
                for n in names),
            "route on the card differs from the CPU's on the same logits")
    dropped = 1.0 - float(rc.keep.float().mean())
    require(dropped > 0, f"no assignment dropped at capacity factor "
            f"{MOE_DROP_CF}")
    return {"capacity_factor": MOE_DROP_CF,
            "capacity": MOE.capacity(logits.shape[0], cfg),
            "tokens": logits.shape[0], "dropped_share": dropped,
            "max_abs_err": err, "out_scale": scale, "aux_rel_err": aux_err,
            "min_topk_gap": gap, "route_equal": list(names)}


def run_moe(seed: int) -> dict:
    """The moe phase: qwen2-moe-a2.7b on the card with weights
    from ``seed``, each path with its own launch check.  The prefill
    (``make_prefill_step``, B ``MOE_BATCH`` x ``MOE_LEN``, bf16, capacity
    factor 1.25) launches ``flash_attention`` once a layer (24) and no
    other kernel: routing, dispatch and the expert GEMMs are torch ops, as
    the reference's are jnp; the forward once more with ``moe.route``
    watched gives the share of assignments dropped, and its aux loss.
    The kernel against its plain version at layer 0's inputs, beside its
    bound and SDPA.  float32 step decode against the forward at capacity
    factor ``n_experts / top_k`` (no drop); ``serve.main`` (no kernel) and
    with ``--compress-kv`` through a "cuda"-encode codec; ``MOE_TRAIN_LAYERS``
    layers at full width trained ``MOE_TRAIN_STEPS`` ``make_train_step``
    steps (remat: 2 launches a layer a step); the reduced train step, the
    reduced ``moe_block`` with drops and ``route``, the card against the
    CPU.  Every parameter of a path is freed before the next path makes
    its own (two float32 copies would take 115 GB).  Prints and returns
    one ``moe`` row."""
    import dataclasses
    import gc
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as O

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = configs.get_config(MOE_ARCH)
    gen = T.generator(seed + 3, "cuda")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, cfg, "cuda")
    leaves = list(_leaves(params))
    row = {"params": sum(t.numel() for t in leaves),
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "layers": cfg.n_layers, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor}
    del leaves

    # -- the prefill: 24 flash_attention launches, nothing else ----------
    tokens = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_LEN), generator=gen,
                           device="cuda")
    n_tok = tokens.numel()
    step = St.make_prefill_step(cfg)
    logits, counts = run_path(f"{MOE_ARCH} prefill", ("flash_attention",),
                              lambda: step(params, tokens))
    require(counts["flash_attention"] == cfg.n_layers,
            f"{MOE_ARCH}: {counts['flash_attention']} flash_attention "
            f"launches in the prefill, not {cfg.n_layers}")
    require(tuple(logits.shape) == (MOE_BATCH, MOE_LEN, cfg.vocab)
            and logits.dtype == torch.bfloat16
            and bool(torch.isfinite(logits).all()),
            f"{MOE_ARCH}: prefill logits {logits.dtype}{list(logits.shape)}")
    del logits
    ms = cuda_ms(lambda: step(params, tokens), 2)
    row.update(prefill_launches=counts["flash_attention"],
               prefill_shape=[MOE_BATCH, MOE_LEN], prefill_ms=ms,
               prefill_tok_per_s=n_tok / (ms * 1e-3),
               capacity=MOE.capacity(n_tok, cfg))

    # -- the forward again, route watched: aux and the dropped share -----
    kept = []
    real = MOE.route

    def watched(lg, c):
        r = real(lg, c)
        kept.append(r.keep.sum())
        return r

    MOE.route = watched
    try:
        with torch.inference_mode():
            _, aux = T.forward_hidden(params, tokens, cfg)
    finally:
        MOE.route = real
    aux = float(aux)
    require(len(kept) == cfg.n_layers and math.isfinite(aux) and aux > 0,
            f"{MOE_ARCH}: forward aux {aux} over {len(kept)} routed layers")
    row["aux"] = aux
    row["dropped_share"] = 1.0 - float(torch.stack(kept).sum()) / (
        cfg.n_layers * n_tok * cfg.top_k)

    # -- layer 0's attention: the kernel, its bound, plain and SDPA ------
    with torch.inference_mode():
        x = params["embed"][tokens].to(cfg.cdt)
        lp = params["layers"][0]
        q, k, v = A.attn_kernel_inputs(*A._project_qkv(
            L.rms_norm(x, lp["ln1"]), lp["attn"], cfg,
            T._positions(cfg, MOE_LEN, "cuda")))
    kw = {"causal": True, "scale": 1.0}
    layer0 = check_flash_at(q, k, v, kw, f"{MOE_ARCH} layer 0")
    layer0["plain_ms"] = cuda_ms(
        lambda: FA.flash_attention_plain(q, k, v, **kw), 1)
    q4, k4, v4 = (t.view(MOE_BATCH, t.shape[0] // MOE_BATCH, MOE_LEN,
                         t.shape[-1]) for t in (q, k, v))
    layer0["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=1.0), 5)
    layer0["library_call"] = ("F.scaled_dot_product_attention(q, k, v, "
                              "is_causal=True, scale=1.0)")
    row["layer0_kernel"] = layer0
    del x, q, k, v, q4, k4, v4

    # -- float32 step decode against the forward, nothing dropped --------
    dcfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)
    caps = (MOE.capacity(FAMILY_DECODE_LEN, dcfg), MOE.capacity(1, dcfg))
    require(caps == (FAMILY_DECODE_LEN, 1), f"{MOE_ARCH}: capacities {caps} "
            f"at capacity factor {dcfg.capacity_factor}")
    print(f"{MOE_ARCH} decode check: capacity factor "
          f"{dcfg.capacity_factor} gives the forward {caps[0]} slots an "
          f"expert for its {FAMILY_DECODE_LEN} tokens and a step {caps[1]} "
          f"for its 1: no assignment drops")
    row["decode_vs_forward_f32"] = {
        **decode_against_forward(dcfg, params, torch.randint(
            0, cfg.vocab, (1, FAMILY_DECODE_LEN), generator=gen,
            device="cuda"), MOE_ARCH),
        "capacity_factor": dcfg.capacity_factor,
        "capacity_forward": caps[0], "capacity_step": caps[1]}
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, tokens, step
    free()

    # -- serve.main: plain (no kernel), then --compress-kv ---------------
    torch.cuda.reset_peak_memory_stats()
    row["serve"], _ = serve_row(MOE_ARCH, [], (), seed)
    free()
    row["serve_compress_kv"], _ = serve_row(
        MOE_ARCH, ["--compress-kv", "--kv-encode-backend", "cuda"],
        SERVE_KV_KERNELS, seed)
    row["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    free()

    # -- MOE_TRAIN_LAYERS layers at full width through make_train_step ---
    tcfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    ocfg = O.AdamWConfig()
    params = T.init_model(seed, tcfg, "cuda")
    opt = O.init(params, ocfg)
    n_params = sum(t.numel() for t in _leaves(params))
    data = SyntheticLM(DataConfig(vocab=tcfg.vocab, seq_len=MOE_TRAIN_SEQ,
                                  global_batch=MOE_TRAIN_BATCH, seed=seed),
                       device="cuda")
    step_fn = St.make_train_step(tcfg, ocfg)
    times, losses, auxes = [], [], []

    def train_steps():
        nonlocal params, opt
        for s in range(MOE_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, data.batch_at(s))
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            times.append((time.perf_counter() - t0) * 1e3)

    _, tcounts = run_path(f"{MOE_ARCH} train", ("flash_attention",),
                          train_steps)
    want = MOE_TRAIN_STEPS * tcfg.n_layers * 2
    require(tcounts["flash_attention"] == want,
            f"{MOE_ARCH} train: {tcounts['flash_attention']} flash_attention "
            f"launches, not {want} (forward and recompute a layer a step)")
    require(all(np.isfinite(losses)) and all(a > 0 for a in auxes),
            f"{MOE_ARCH} train: losses {losses}, aux {auxes}")
    row["train"] = {
        "layers": tcfg.n_layers, "params": n_params,
        "steps": MOE_TRAIN_STEPS, "batch": MOE_TRAIN_BATCH,
        "seq": MOE_TRAIN_SEQ,
        "capacity": MOE.capacity(MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, tcfg),
        "step_ms": times, "losses": losses, "aux": auxes,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_launches": tcounts["flash_attention"]}
    del params, opt, data, step_fn
    free()

    # -- the reduced config, the card against the CPU --------------------
    row["train_card_vs_cpu"] = check_train_step(MOE_ARCH, seed)
    row["moe_block_card_vs_cpu"] = check_moe_block(seed)
    row["phase_s"] = time.perf_counter() - t_phase
    print(f"moe {json.dumps(row)}")
    return row


def sdpa_backends(q, k, v, **kw) -> dict:
    """``scaled_dot_product_attention`` on (B, H, S, D) inputs under each
    fused backend alone (flash, memory-efficient, cuDNN): its ms, or the
    first line of its refusal (a backend takes D != Dv or does not).  The
    yardstick only: the port calls none of them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        with sdpa_kernel(backend):
            try:
                F.scaled_dot_product_attention(q, k, v, **kw)
            except RuntimeError as e:
                out[name] = "refused: " + str(e).strip().splitlines()[0][:160]
                continue
            out[name] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, **kw), 5)
    return out


def run_mla(seed: int) -> dict:
    """The mla phase: deepseek-v3-671b at its published widths cut to
    ``MLA_LAYERS`` layers, weights from ``seed`` on the card, each path
    with its own launch check.  The prefill (``make_prefill_step``, B
    ``MLA_BATCH`` x ``MLA_LEN``, bf16) launches ``flash_attention`` once a
    layer at D 192 over Dv 128 and no other kernel (the latents, routing
    and experts are torch ops, as the reference's are jnp); the forward
    again with ``moe.route`` watched gives the dropped share, and its aux
    loss.  The kernel against its plain version at layer 0's inputs,
    beside its bound, its plain version and each SDPA backend that takes
    D != Dv.  A greedy decode loop through ``make_serve_step`` (no
    kernel: ``mla_decode`` attends the latent cache in torch ops).  float32
    step decode against the forward (float32 parameters, capacity factor
    ``n_experts / top_k``: nothing drops), whose forward runs the float32
    kernel at D 192; ``serve.main`` of the reduced config, plain and with
    ``--compress-kv``; the gradient (``grads_of``) of ``MLA_TRAIN_LAYERS``
    layers and the MTP head, remat on; the reduced train step, the card
    against the CPU.  Every parameter of a path is freed before the next
    path makes its own.  Prints and returns one ``mla`` row."""
    import dataclasses
    import gc
    import math

    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.models import attention as A
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as MOE
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    full = configs.get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    gen = T.generator(seed + 4, "cuda")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def sizes(params):
        leaves = list(_leaves(params))
        return {"params": sum(t.numel() for t in leaves),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in leaves)}

    free()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, cfg, "cuda")
    row = {**sizes(params), "layers": cfg.n_layers,
           "dense_layers": cfg.first_k_dense, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
           "head": {"d": cfg.qk_nope_dim + cfg.qk_rope_dim,
                    "dv": cfg.v_head_dim, "heads": cfg.n_heads}}

    # -- the prefill: a flash_attention launch a layer, nothing else -----
    tokens = torch.randint(0, cfg.vocab, (MLA_BATCH, MLA_LEN), generator=gen,
                           device="cuda")
    n_tok = tokens.numel()
    step = St.make_prefill_step(cfg)
    logits, counts = run_path(f"{MLA_ARCH} prefill", ("flash_attention",),
                              lambda: step(params, tokens))
    require(counts["flash_attention"] == cfg.n_layers,
            f"{MLA_ARCH}: {counts['flash_attention']} flash_attention "
            f"launches in the prefill, not {cfg.n_layers}")
    require(tuple(logits.shape) == (MLA_BATCH, MLA_LEN, cfg.vocab)
            and logits.dtype == torch.bfloat16
            and bool(torch.isfinite(logits).all()),
            f"{MLA_ARCH}: prefill logits {logits.dtype}{list(logits.shape)}")
    del logits
    ms = cuda_ms(lambda: step(params, tokens), 2)
    row.update(prefill_launches=counts["flash_attention"],
               prefill_shape=[MLA_BATCH, MLA_LEN], prefill_ms=ms,
               prefill_tok_per_s=n_tok / (ms * 1e-3),
               capacity=MOE.capacity(n_tok, cfg))

    # -- the forward again, route watched: aux and the dropped share -----
    kept, loads = [], []
    real = MOE.route

    def watched(lg, c):
        r = real(lg, c)
        kept.append(r.keep.sum())
        loads.append(r.assign.sum(0))
        return r

    MOE.route = watched
    try:
        with torch.inference_mode():
            _, aux = T.forward_hidden(params, tokens, cfg)
    finally:
        MOE.route = real
    aux = float(aux)
    n_moe = cfg.n_layers - cfg.first_k_dense
    require(len(kept) == n_moe and math.isfinite(aux) and aux > 0,
            f"{MLA_ARCH}: forward aux {aux} over {len(kept)} routed layers")
    row["aux"] = aux
    row["dropped_share"] = 1.0 - float(torch.stack(kept).sum()) / (
        n_moe * n_tok * cfg.top_k)
    # each expert's assignments before the drops: how the router spreads
    # the tokens over the experts' row["capacity"] slots
    load = torch.stack(loads).float()
    row["expert_load"] = {
        "max": int(load.max()), "median": float(load.median()),
        "experts_routed_to": int((load > 0).sum()),
        "experts_over_capacity": int((load > row["capacity"]).sum())}
    row["prefill_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # -- layer 0's attention: the kernel, its bound, plain and SDPA ------
    with torch.inference_mode():
        lp = params["dense_layers"][0]
        xn = L.rms_norm(params["embed"][tokens].to(cfg.cdt), lp["ln1"])
        q, c_kv, k_rope = MLA._latents(xn, lp["attn"], cfg,
                                       T._positions(cfg, MLA_LEN, "cuda"))
        k, v = MLA._expand_kv(c_kv, k_rope, lp["attn"], cfg, cfg.cdt)
        q, k, v = A.attn_kernel_inputs(q, k, v)
        del xn, c_kv, k_rope
    kw = {"causal": True, "scale": 1.0}
    layer0 = check_flash_at(q, k, v, kw, f"{MLA_ARCH} layer 0")
    require(layer0["shape"] == [[MLA_BATCH * cfg.n_heads, MLA_LEN, 192],
                                [MLA_BATCH * cfg.n_heads, MLA_LEN, 192],
                                [MLA_BATCH * cfg.n_heads, MLA_LEN, 128]],
            f"{MLA_ARCH}: layer 0's kernel inputs {layer0['shape']}")
    layer0["plain_ms"] = cuda_ms(
        lambda: FA.flash_attention_plain(q, k, v, **kw), 1)
    q4, k4, v4 = (t.view(MLA_BATCH, cfg.n_heads, MLA_LEN, t.shape[-1])
                  for t in (q, k, v))
    layer0["sdpa"] = sdpa_backends(q4, k4, v4, is_causal=True, scale=1.0)
    taken = [ms for ms in layer0["sdpa"].values() if not isinstance(ms, str)]
    layer0["library_ms"] = min(taken) if taken else None
    layer0["library_call"] = (
        "F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=1.0)"
        " under the fastest fused backend that takes D 192 != Dv 128"
        if taken else "none: no fused SDPA backend takes D 192 != Dv 128")
    row["layer0_kernel"] = layer0
    del q, k, v, q4, k4, v4

    # -- a greedy decode loop through make_serve_step: no kernel ---------
    serve_step = St.make_serve_step(cfg)

    def decode_loop():
        cache = D.init_cache(cfg, MLA_DECODE_BATCH, MLA_DECODE_STEPS, "cuda")
        tok = torch.randint(0, cfg.vocab, (MLA_DECODE_BATCH, 1),
                            generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MLA_DECODE_STEPS):
            lg, cache = serve_step(params, tok, cache, t)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(lg).all()) and bool(
            cache["latent"].ne(0).any(-1).all()),
            f"{MLA_ARCH}: decode logits not finite, or a latent entry "
            f"left unwritten")
        return time.perf_counter() - t0

    run_path(f"{MLA_ARCH} decode", (), decode_loop)
    secs = decode_loop()
    row["decode"] = {
        "batch": MLA_DECODE_BATCH, "steps": MLA_DECODE_STEPS, "s": secs,
        "ms_a_step": secs * 1e3 / MLA_DECODE_STEPS,
        "tok_per_s": MLA_DECODE_BATCH * MLA_DECODE_STEPS / secs,
        "latent_cache": list(D.cache_spec(cfg, MLA_DECODE_BATCH,
                                          MLA_DECODE_STEPS)["latent"][0])}
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, tokens, step, serve_step
    free()

    # -- float32 step decode against the forward, nothing dropped --------
    dcfg = dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32",
                               capacity_factor=cfg.n_experts / cfg.top_k)
    caps = (MOE.capacity(FAMILY_DECODE_LEN, dcfg), MOE.capacity(1, dcfg))
    require(caps == (FAMILY_DECODE_LEN, 1), f"{MLA_ARCH}: capacities {caps} "
            f"at capacity factor {dcfg.capacity_factor}")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, dcfg, "cuda")
    f32 = sizes(params)
    check, dcounts = run_path(
        f"{MLA_ARCH} float32 decode check", ("flash_attention",),
        lambda: decode_against_forward(dcfg, params, torch.randint(
            0, cfg.vocab, (1, FAMILY_DECODE_LEN), generator=gen,
            device="cuda"), MLA_ARCH))
    require(dcounts["flash_attention"] == cfg.n_layers,
            f"{MLA_ARCH}: the float32 forward launched "
            f"{dcounts['flash_attention']} flash_attention, not "
            f"{cfg.n_layers}")
    row["decode_vs_forward_f32"] = {
        **check, **f32, "capacity_factor": dcfg.capacity_factor,
        "capacity_forward": caps[0], "capacity_step": caps[1],
        "forward_launches": dcounts["flash_attention"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params
    free()

    # -- serve.main of the reduced config: plain, then --compress-kv -----
    row["serve_reduced"], _ = serve_row(MLA_ARCH, ["--reduced"], (), seed)
    row["serve_reduced_compress_kv"], _ = serve_row(
        MLA_ARCH, ["--reduced", "--compress-kv", "--kv-encode-backend",
                   "cuda"], SERVE_KV_KERNELS, seed)
    free()

    # -- MLA_TRAIN_LAYERS layers and the MTP head: the gradient ----------
    tcfg = dataclasses.replace(full, n_layers=MLA_TRAIN_LAYERS,
                               first_k_dense=1)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, tcfg, "cuda")
    tsizes = sizes(params)
    batch = SyntheticLM(DataConfig(vocab=tcfg.vocab, seq_len=MLA_TRAIN_SEQ,
                                   global_batch=MLA_TRAIN_BATCH, seed=seed),
                        device="cuda").batch_at(0)
    times = []

    def grads():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = St.grads_of(params, batch, tcfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    ((loss, metrics), g), tcounts = run_path(
        f"{MLA_ARCH} train", ("flash_attention",), grads)
    want = 2 * tcfg.n_layers + 1
    require(tcounts["flash_attention"] == want,
            f"{MLA_ARCH} train: {tcounts['flash_attention']} flash_attention "
            f"launches, not {want} (forward and recompute a layer, the MTP "
            f"block's forward)")
    vals = {k: float(v) for k, v in metrics.items()}
    require(math.isfinite(float(loss)) and sorted(vals) == [
        "aux", "ce", "mtp"] and all(math.isfinite(v) for v in vals.values())
        and vals["aux"] > 0, f"{MLA_ARCH} train: loss {float(loss)}, "
        f"metrics {vals}")
    zero = [name for name, t in _named_leaves({
        "dense_layers": {"attn": g["dense_layers"][0]["attn"]},
        "layers": {"attn": g["layers"][0]["attn"]}, "mtp": g["mtp"]})
        if not bool(t.ne(0).any())]
    require(not zero, f"{MLA_ARCH} train: zero gradient on {zero}")
    n_grad = sum(t.numel() for t in _leaves(g))
    del g
    free()
    grads()
    row["train"] = {
        **tsizes, "layers": tcfg.n_layers, "dense_layers": 1,
        "mtp_head": True,
        "batch": MLA_TRAIN_BATCH, "seq": MLA_TRAIN_SEQ,
        "capacity": MOE.capacity(MLA_TRAIN_BATCH * MLA_TRAIN_SEQ, tcfg),
        "grads_ms": times, "loss": float(loss), **vals,
        "grad_values": n_grad,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_launches": tcounts["flash_attention"]}
    del params, batch
    free()

    # -- the reduced config, the card against the CPU --------------------
    row["train_card_vs_cpu"] = check_train_step(MLA_ARCH, seed,
                                                param_dtype="float32")
    row["phase_s"] = time.perf_counter() - t_phase
    print(f"mla {json.dumps(row)}")
    return row


def run_hybrid(seed: int) -> dict:
    """The hybrid phase: zamba2-7b at its published widths and full depth,
    weights from ``seed`` on the card, each path with its own launch
    check.  The prefill (``make_prefill_step``, B ``HYBRID_BATCH`` x
    ``HYBRID_LEN``, bf16) launches ``flash_attention`` once an invocation
    of the shared block (13, windowed at 4,096, D 112 padded to the
    128-wide template) and no other kernel (the Mamba2 layers' chunked
    SSD is torch ops, as the reference's is jnp); one more prefill under
    the profiler gives the device's idle share.  The kernel against its
    plain version at the block's first invocation, beside its bound and
    SDPA with the boolean window mask.  A greedy decode loop through
    ``make_serve_step`` (no kernel).  float32 step decode against the
    forward (float32 parameters), whose forward runs the float32 kernel;
    ``serve.main`` plain and with ``--compress-kv``, and the reduced
    config with ``--kv-offload``; the gradient (``grads_of``) and one
    ``make_train_step`` AdamW step of ``HYBRID_TRAIN_LAYERS`` layers,
    remat on; the reduced train step, the card against the CPU.  Every
    parameter of a path is freed before the next path makes its own.
    Prints and returns one ``hybrid`` row."""
    import dataclasses
    import gc
    import math
    import shutil

    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.models import decode as D
    from repro_torch.models import ssm as SSM
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.models.config import count_params
    from repro_torch.optim import adamw as O

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = configs.get_config(HYBRID_ARCH)
    every = cfg.hybrid_attn_every
    n_inv = D.n_invocations(cfg)
    gen = T.generator(seed + 5, "cuda")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def sizes(params):
        leaves = list(_leaves(params))
        return {"params": sum(t.numel() for t in leaves),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in leaves)}

    free()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, cfg, "cuda")
    dv, h, ph = SSM.ssm_dims(cfg)
    row = {**sizes(params), "count_params": count_params(cfg),
           "layers": cfg.n_layers, "attn_every": every,
           "invocations": n_inv, "window": cfg.swa_window,
           "ssm": {"heads": h, "head": ph, "state": cfg.ssm_state,
                   "chunk": cfg.ssm_chunk},
           "attn_head": {"d": cfg.head_dim, "heads": cfg.n_heads,
                         "kv_heads": cfg.n_kv_heads}}

    # -- the prefill: a windowed flash_attention launch an invocation ----
    tokens = torch.randint(0, cfg.vocab, (HYBRID_BATCH, HYBRID_LEN),
                           generator=gen, device="cuda")
    n_tok = tokens.numel()
    step = St.make_prefill_step(cfg)
    logits, counts = run_path(f"{HYBRID_ARCH} prefill", ("flash_attention",),
                              lambda: step(params, tokens))
    require(counts["flash_attention"] == n_inv,
            f"{HYBRID_ARCH}: {counts['flash_attention']} flash_attention "
            f"launches in the prefill, not {n_inv}")
    require(tuple(logits.shape) == (HYBRID_BATCH, HYBRID_LEN, cfg.vocab)
            and logits.dtype == torch.bfloat16
            and bool(torch.isfinite(logits).all()),
            f"{HYBRID_ARCH}: prefill logits {logits.dtype}"
            f"{list(logits.shape)}")
    del logits
    row["prefill_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ms = cuda_ms(lambda: step(params, tokens), 1)
    _, prof = profile_once(lambda: step(params, tokens), top=10)
    nc = HYBRID_LEN // SSM.chunk_len(HYBRID_LEN, cfg.ssm_chunk)
    row.update(prefill_launches=counts["flash_attention"],
               prefill_shape=[HYBRID_BATCH, HYBRID_LEN], prefill_ms=ms,
               prefill_tok_per_s=n_tok / (ms * 1e-3), prefill_profile=prof,
               ssd_chunks=nc, chunk_loop_steps=nc * cfg.n_layers)

    # -- the shared block's first invocation: the kernel, bound, SDPA ----
    q, k, v = first_kernel_inputs(cfg, params, tokens)
    kw = {"causal": True, "scale": 1.0, "window": cfg.swa_window}
    first = check_flash_at(q, k, v, kw, f"{HYBRID_ARCH} invocation 0")
    require(first["shape"] == [
        [HYBRID_BATCH * heads, HYBRID_LEN, cfg.head_dim]
        for heads in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)],
            f"{HYBRID_ARCH}: the first invocation's kernel inputs "
            f"{first['shape']}")
    first["plain_ms"] = cuda_ms(
        lambda: FA.flash_attention_plain(q, k, v, **kw), 1)
    q4, k4, v4 = (t.view(HYBRID_BATCH, t.shape[0] // HYBRID_BATCH,
                         HYBRID_LEN, t.shape[-1]) for t in (q, k, v))
    mask = FA.visible_mask(HYBRID_LEN, HYBRID_LEN, causal=True,
                           window=cfg.swa_window, device="cuda")

    def library():
        return F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=1.0,
            enable_gqa=cfg.n_heads != cfg.n_kv_heads)

    out = FA.flash_attention(q, k, v, **kw)
    first["library_max_abs_err"] = max_abs_err(
        library().reshape(out.shape), out)
    first["library_ms"] = cuda_ms(library, 5)
    first["library_call"] = ("F.scaled_dot_product_attention(q, k, v, "
                             "attn_mask=<bool (S, S) window mask>, "
                             "scale=1.0)")
    first["pairs"] = cost.flash_pairs(HYBRID_LEN, HYBRID_LEN, True,
                                 cfg.swa_window)
    row["layer0_kernel"] = first
    del q, k, v, q4, k4, v4, mask, out

    # -- a greedy decode loop through make_serve_step: no kernel ---------
    serve_step = St.make_serve_step(cfg)
    n_steps = HYBRID_DECODE_PROMPT + HYBRID_DECODE_STEPS
    prompt = torch.randint(0, cfg.vocab, (HYBRID_DECODE_BATCH,
                                          HYBRID_DECODE_PROMPT),
                           generator=gen, device="cuda")

    def decode_loop():
        # one slot more: the profiled step after the loop
        cache = D.init_cache(cfg, HYBRID_DECODE_BATCH, n_steps + 1, "cuda")
        for t in range(HYBRID_DECODE_PROMPT):
            lg, cache = serve_step(params, prompt[:, t:t + 1], cache, t)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(HYBRID_DECODE_PROMPT, n_steps):
            lg, cache = serve_step(params, tok, cache, t)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(bool(torch.isfinite(lg).all())
                and bool(cache["k"][:, :, :n_steps].ne(0).any(-1).all())
                and bool(cache["ssm"].ne(0).any()),
                f"{HYBRID_ARCH}: decode logits not finite, or a cache "
                f"entry left unwritten")
        return secs, cache, tok

    run_path(f"{HYBRID_ARCH} decode", (), decode_loop)
    secs, cache, tok = decode_loop()
    _, step_prof = profile_once(
        lambda: serve_step(params, tok, cache, n_steps), top=8)
    del cache
    spec = D.cache_spec(cfg, HYBRID_DECODE_BATCH, n_steps + 1)
    row["decode"] = {
        "batch": HYBRID_DECODE_BATCH, "prompt": HYBRID_DECODE_PROMPT,
        "steps": HYBRID_DECODE_STEPS, "s": secs,
        "ms_a_step": secs * 1e3 / HYBRID_DECODE_STEPS,
        "tok_per_s": HYBRID_DECODE_BATCH * HYBRID_DECODE_STEPS / secs,
        "step_profile": step_prof,
        "cache": {name: list(shape) for name, (shape, _) in spec.items()}}
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, tokens, prompt, step, serve_step
    free()

    # -- float32 step decode against the forward -------------------------
    dcfg = dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, dcfg, "cuda")
    f32 = sizes(params)
    check, dcounts = run_path(
        f"{HYBRID_ARCH} float32 decode check", ("flash_attention",),
        lambda: decode_against_forward(dcfg, params, torch.randint(
            0, cfg.vocab, (1, HYBRID_F32_LEN), generator=gen,
            device="cuda"), HYBRID_ARCH))
    require(dcounts["flash_attention"] == n_inv,
            f"{HYBRID_ARCH}: the float32 forward launched "
            f"{dcounts['flash_attention']} flash_attention, not {n_inv}")
    row["decode_vs_forward_f32"] = {
        **check, **f32, "tokens": HYBRID_F32_LEN,
        "forward_launches": dcounts["flash_attention"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params
    free()

    # -- serve.main: plain, --compress-kv; the reduced with --kv-offload -
    directory = os.path.join(ROOT, "build", "chip_smoke_hybrid")
    shutil.rmtree(directory, ignore_errors=True)
    row["serve"], _ = serve_row(HYBRID_ARCH, [], (), seed)
    free()
    row["serve_compress_kv"], _ = serve_row(
        HYBRID_ARCH, ["--compress-kv", "--kv-encode-backend", "cuda"],
        SERVE_KV_KERNELS, seed)
    free()
    row["serve_reduced_kv_offload"], _ = serve_row(
        HYBRID_ARCH, ["--reduced", "--kv-offload", "--kv-block",
                      str(HYBRID_KV_BLOCK), "--kv-encode-backend", "cuda",
                      "--kv-offload-dir", directory], SERVE_KV_KERNELS, seed)
    shutil.rmtree(directory, ignore_errors=True)
    free()

    # -- HYBRID_TRAIN_LAYERS layers: the gradient, one AdamW step --------
    tcfg = dataclasses.replace(cfg, n_layers=HYBRID_TRAIN_LAYERS)
    t_inv = D.n_invocations(tcfg)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_model(seed, tcfg, "cuda")
    tsizes = sizes(params)
    batch = SyntheticLM(DataConfig(vocab=tcfg.vocab,
                                   seq_len=HYBRID_TRAIN_SEQ,
                                   global_batch=HYBRID_TRAIN_BATCH,
                                   seed=seed), device="cuda").batch_at(0)
    want = 2 * t_inv
    times = {"grads_ms": [], "step_ms": []}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)
        return out

    ((loss, metrics), g), gcounts = run_path(
        f"{HYBRID_ARCH} gradient", ("flash_attention",),
        lambda: timed("grads_ms", lambda: St.grads_of(params, batch, tcfg)))
    require(gcounts["flash_attention"] == want,
            f"{HYBRID_ARCH} gradient: {gcounts['flash_attention']} "
            f"flash_attention launches, not {want} (forward and recompute "
            f"an invocation)")
    require(math.isfinite(float(loss)) and all(math.isfinite(float(v))
                                               for v in metrics.values()),
            f"{HYBRID_ARCH} gradient: loss {float(loss)}")
    zero = [name for name, t in _named_leaves({
        "shared_attn": g["shared_attn"],
        "layers": [lp["ssm"] for lp in g["layers"]]})
        if not bool(t.ne(0).any()) or not bool(torch.isfinite(t).all())]
    require(not zero, f"{HYBRID_ARCH} gradient: zero or non-finite "
            f"gradient on {zero}")
    n_grad = sum(t.numel() for t in _leaves(g))
    del g
    free()
    ocfg = O.AdamWConfig()
    train_step = St.make_train_step(tcfg, ocfg)
    opt = O.init(params, ocfg)
    (new, opt, smet), scounts = run_path(
        f"{HYBRID_ARCH} train step", ("flash_attention",),
        lambda: timed("step_ms", lambda: train_step(params, opt, batch)))
    require(scounts["flash_attention"] == want
            and math.isfinite(float(smet["loss"]))
            and abs(float(smet["loss"]) - float(loss)) <= 1e-3 * abs(
                float(loss)),
            f"{HYBRID_ARCH} train step: {scounts['flash_attention']} "
            f"launches, loss {float(smet['loss'])} against the gradient's "
            f"{float(loss)}")
    moved = sum(int((a != b).sum()) for a, b in zip(_leaves(new),
                                                    _leaves(params)))
    require(moved > 0, f"{HYBRID_ARCH} train step moved no parameter")
    del new
    free()
    timed("step_ms", lambda: train_step(params, opt, batch))
    row["train"] = {
        **tsizes, "layers": tcfg.n_layers, "invocations": t_inv,
        "batch": HYBRID_TRAIN_BATCH, "seq": HYBRID_TRAIN_SEQ, **times,
        "loss": float(loss), "grad_norm": float(smet["grad_norm"]),
        "grad_values": n_grad, "moved_values": moved,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_launches": gcounts["flash_attention"]}
    del params, batch, opt
    free()

    # -- the reduced config, the card against the CPU --------------------
    row["train_card_vs_cpu"] = check_train_step(HYBRID_ARCH, seed,
                                                param_dtype="float32")
    row["phase_s"] = time.perf_counter() - t_phase
    print(f"hybrid {json.dumps(row)}")
    return row


def _grads(fn, inputs, cotangents, **kw):
    """``fn(*inputs, **kw)`` under autograd from fresh leaves: (outputs,
    the inputs' gradients) for the loss ``sum(out_i * cotangent_i)``."""
    import torch

    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in inputs]
    out = fn(*leaves, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * c).sum() for o, c in zip(outs, cotangents))
    loss.backward()
    return outs, [t.grad for t in leaves if t is not None]


def check_trainable(kname, inputs, stage: str, **kw) -> float:
    """The gradients of ``kname``'s trainable function on the card (the
    kernel forward, the torch-ops backward) against autograd through its
    plain version, from the same inputs and random cotangents: flash's
    dq, dk, dv within one bfloat16 ulp of each gradient's scale in
    bfloat16 (both compute in float32 and round once), 1e-4 of it in
    float32; gla's r, k, v, w, u and state gradients within 1e-4 of it
    (sums in another order; the forward's boundary states come from the
    kernel).  Fails unless the forward launched the kernel.  Returns the
    largest difference over the scale."""
    import torch

    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import rwkv_gla as GLA
    from repro_torch.testing import kernel_cases as KC

    gen = torch.Generator(device="cuda")
    gen.manual_seed(len(stage))
    if kname == "flash_attention":
        trainable, plain, wrapper = (FA.flash_attention_trainable,
                                     FA.flash_attention_plain,
                                     FA.flash_attention)
        q, _, v = inputs
        shapes = [(q.shape[0], q.shape[1], v.shape[2])]
    else:
        trainable, plain, wrapper = (GLA.gla_time_mix_trainable,
                                     GLA.gla_time_mix_plain,
                                     GLA.gla_time_mix)
        r, _, v = inputs[:3]
        shapes = [(r.shape[0], r.shape[1], v.shape[2]),
                  (r.shape[0], r.shape[2], v.shape[2])]
    cot = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    before = wrapper.launches
    _, got = _grads(trainable, inputs, cot, **kw)
    require(wrapper.launches > before,
            f"{stage}: {kname}'s trainable forward launched no kernel")
    _, want = _grads(plain, inputs, cot, **kw)
    worst = 0.0
    for g, w in zip(got, want):
        require(g.dtype == w.dtype and g.shape == w.shape
                and bool(torch.isfinite(g).all()),
                f"{stage}: {kname} gradient {g.dtype}{list(g.shape)}")
        scale = max(1e-30, float(w.float().abs().max()))
        tol = (KC.bf16_ulp(scale) if w.dtype == torch.bfloat16
               else 1e-4 * scale)
        err = max_abs_err(g, w)
        require(err <= tol, f"{stage}: {kname} gradient differs from "
                f"autograd through its plain version by {err} > {tol}")
        worst = max(worst, err / scale)
    return worst


def _train_step_on(cfg, params, batch, ocfg):
    """``grads_of`` and one ``make_train_step`` step at ``params``."""
    from repro_torch.models import steps as St
    from repro_torch.optim import adamw as O

    (loss, _), grads = St.grads_of(params, batch, cfg)
    new, _, metrics = St.make_train_step(cfg, ocfg)(
        params, O.init(params, ocfg), batch)
    return float(loss), grads, new, metrics


def check_train_step(arch: str, seed: int, **over) -> dict:
    """One train step of the reduced ``arch`` (float32 compute) on the card
    and on the CPU from the same parameters and batch: the loss within
    1e-5 relative, each gradient within 1e-4 of its leaf's scale, the grad
    norm within 1e-5, and every updated parameter within a quarter of the
    learning rate (AdamW's first step moves a parameter by about ``lr *
    sign(g)``: a gradient cut at a kernel moves it by ``lr`` the other
    way).  Fails unless the card's step launched the kernel.  encdec gets
    seeded stub frames; the reduced danube's 64 tokens pass its window of
    32.  ``over``: more fields of the reduced config (deepseek's float32
    parameters: its bf16 ones would round each gradient)."""
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import launches
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as O

    cfg = configs.get_config(arch).reduced(compute_dtype="float32", **over)
    kname = ("gla_time_mix" if cfg.family == "rwkv"
             else "flash_attention")
    ocfg = O.AdamWConfig(lr=TRAIN_CHECK_LR)
    cpu = T.init_model(seed, cfg, "cpu")
    card = O.tree_map(lambda t: t.cuda(), cpu)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_CHECK_SEQ,
                                   global_batch=TRAIN_CHECK_BATCH,
                                   seed=seed), device="cpu").batch_at(0)
    if cfg.family == "encdec":   # seeded stub frames for the encoder
        gen = torch.Generator().manual_seed(seed)
        batch["extra_embeds"] = torch.randn(
            (TRAIN_CHECK_BATCH, cfg.encoder_seq, cfg.d_model), generator=gen)
    before = launches.counts()[kname]
    lg, gg, ng, mg = _train_step_on(
        cfg, card, {k: v.cuda() for k, v in batch.items()}, ocfg)
    torch.cuda.synchronize()
    n_launch = launches.counts()[kname] - before
    require(n_launch > 0, f"{arch}: the card's train step launched no "
            f"{kname}")
    lc, gc, nc, mc = _train_step_on(cfg, cpu, batch, ocfg)
    require(abs(lg - lc) <= 1e-5 * abs(lc),
            f"{arch}: card loss {lg} against the CPU's {lc}")
    grad_err = 0.0
    for a, b in zip(O.tree_leaves(gg), O.tree_leaves(gc)):
        scale = max(1e-30, float(b.abs().max()))
        err = max_abs_err(a.cpu(), b)
        require(err <= 1e-4 * scale, f"{arch}: a gradient differs between "
                f"the card and the CPU by {err} (scale {scale})")
        grad_err = max(grad_err, err / scale)
    gn_g, gn_c = float(mg["grad_norm"]), float(mc["grad_norm"])
    require(abs(gn_g - gn_c) <= 1e-5 * gn_c and abs(
        float(mg["loss"]) - lc) <= 1e-5 * abs(lc),
        f"{arch}: grad norm {gn_g} / {gn_c}")
    param_err = max(max_abs_err(a.cpu(), b) for a, b in zip(
        O.tree_leaves(ng), O.tree_leaves(nc)))
    require(param_err <= 0.25 * TRAIN_CHECK_LR,
            f"{arch}: an updated parameter differs between the card and "
            f"the CPU by {param_err} > {0.25 * TRAIN_CHECK_LR}")
    return {"loss_card": lg, "loss_cpu": lc, "grad_norm_card": gn_g,
            "grad_norm_cpu": gn_c, "max_grad_err_over_scale": grad_err,
            "max_param_err": param_err, "kernel_launches": n_launch}


def run_train(seed: int) -> dict:
    """The train phase (A10's training half), each path with its own launch
    check.  qwen3-0.6b at full width trained by ``launch.train.main`` for
    ``TRAIN_STEPS`` steps at B ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (no
    checkpoint): every step launches ``flash_attention`` twice a layer (the
    forward and remat's recompute), its backward torch ops; rwkv6-3b at
    full width cut to ``RWKV_TRAIN_LAYERS`` layers, ``RWKV_TRAIN_STEPS``
    ``make_train_step`` steps at B ``RWKV_TRAIN_BATCH`` x
    ``RWKV_TRAIN_SEQ`` through ``gla_time_mix_trainable`` (the kernel a
    64-step chunk).  Gates: finite losses; the trainable functions'
    gradients on the card against autograd through their plain versions
    (``check_trainable``) at layer 0's shapes and on the random cases of
    ``repro_torch.testing.kernel_cases``; one reduced train step a family
    on the card against the CPU (``check_train_step``); preempt (exit 17)
    and resume of the reduced qwen3 from a compressed checkpoint.  Prints
    and returns one ``train`` row."""
    import contextlib
    import dataclasses
    import io
    import re
    import shutil

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import rwkv_gla as GLA
    from repro_torch.launch import train
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as O
    from repro_torch.testing import kernel_cases as KC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    row = {}

    # -- the trainable functions' gradients against autograd through the
    # plain versions, at layer 0's shapes and on the random cases --------
    qcfg = configs.get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    bh, g = TRAIN_BATCH * qcfg.n_heads, qcfg.n_heads // qcfg.n_kv_heads
    d = qcfg.head_dim

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    grad_errs = {"flash_attention": 0.0, "gla_time_mix": 0.0}
    layer0 = {}
    for dtype in (torch.bfloat16, torch.float32):
        # the model hands the kernel q scaled by D ** -0.5, scale 1.0
        q = randn(bh, TRAIN_SEQ, d, dtype=dtype) * torch.tensor(
            d ** -0.5, dtype=dtype, device="cuda")
        k, v = (randn(bh // g, TRAIN_SEQ, d, dtype=dtype) for _ in "kv")
        layer0[dtype] = (q, k, v)
        grad_errs["flash_attention"] = max(
            grad_errs["flash_attention"], check_trainable(
                "flash_attention", (q, k, v), f"qwen3 layer 0 {dtype}",
                causal=True, scale=1.0))
        for case in KC.FLASH_CASES:
            grad_errs["flash_attention"] = max(
                grad_errs["flash_attention"], check_trainable(
                    "flash_attention", KC.flash_inputs(case, dtype, "cuda",
                                                       seed),
                    f"flash case {case[0]} {dtype}", **KC.flash_kwargs(case)))
    rcfg = dataclasses.replace(configs.get_config("rwkv6-3b"),
                               n_layers=RWKV_TRAIN_LAYERS)
    rbh = RWKV_TRAIN_BATCH * rcfg.d_model // 64
    gla0 = (randn(rbh, RWKV_TRAIN_SEQ, 64), randn(rbh, RWKV_TRAIN_SEQ, 64),
            randn(rbh, RWKV_TRAIN_SEQ, 64),
            torch.rand((rbh, RWKV_TRAIN_SEQ, 64), generator=gen,
                       device="cuda") * 0.1 + 0.899,
            randn(rbh // RWKV_TRAIN_BATCH, 64) * 0.5, None)
    grad_errs["gla_time_mix"] = check_trainable(
        "gla_time_mix", gla0, "rwkv6 layer 0")
    for case in KC.GLA_CASES:
        grad_errs["gla_time_mix"] = max(
            grad_errs["gla_time_mix"], check_trainable(
                "gla_time_mix", KC.gla_inputs(case, "cuda", seed),
                f"gla case {case[0]}"))
    row["gradient_checks"] = {
        "flash_cases": 2 * (1 + len(KC.FLASH_CASES)),
        "gla_cases": 1 + len(KC.GLA_CASES),
        "max_err_over_scale": grad_errs}
    print(f"train gradients {json.dumps(row['gradient_checks'])}")

    # -- one reduced step a family, the card against the CPU -------------
    row["card_vs_cpu"] = {arch: check_train_step(arch, seed)
                          for arch in MODEL_ARCHS}
    print(f"train card vs cpu {json.dumps(row['card_vs_cpu'])}")

    # -- qwen3-0.6b at full width through launch/train.py ----------------
    times, flash_steps, prof = [], [], {}
    real_make = St.make_train_step

    def timed_make(*a, **kw):
        step_fn = real_make(*a, **kw)

        def run(params, opt_state, batch):
            last = len(times) == TRAIN_STEPS - 1
            n0 = FA.flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if last:     # the last step under the profiler, timed apart
                out, stats = profile_once(
                    lambda: step_fn(params, opt_state, batch))
                prof.update(stats)
            else:
                out = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            flash_steps.append(FA.flash_attention.launches - n0)
            return out

        return run

    argv = ["--arch", "qwen3-0.6b", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
            "--seed", str(seed)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    printed = io.StringIO()
    St.make_train_step = timed_make
    try:
        with contextlib.redirect_stdout(printed):
            _, qcounts = run_path("qwen3-0.6b train", ("flash_attention",),
                                  lambda: train.main(argv))
    finally:
        St.make_train_step = real_make
    print(printed.getvalue(), end="")
    losses = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[train\] step=(\d+) loss=([-\d.naif]+)", printed.getvalue())}
    require(sorted(losses) == list(range(TRAIN_STEPS))
            and all(np.isfinite(x) for x in losses.values()),
            f"qwen3-0.6b train losses {losses}")
    want = 2 * qcfg.n_layers
    require(flash_steps == [want] * TRAIN_STEPS,
            f"qwen3-0.6b train: flash_attention launches a step "
            f"{flash_steps}, not {want} (forward and recompute a layer)")
    unprofiled = times[1:TRAIN_STEPS - 1]
    step_ms = float(np.median(unprofiled))
    row["qwen3-0.6b"] = {
        "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "step_ms": times, "median_step_ms_after_step_0": step_ms,
        "median_over": "steps 1 to the one before the profiled last",
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms * 1e-3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_loss": losses[0], "last_loss": losses[TRAIN_STEPS - 1],
        "flash_launches_per_step": flash_steps,
        "train_launches": qcounts["flash_attention"],
        "last_step_profile": prof}
    torch.cuda.empty_cache()

    # the attention backward at layer 0's shape (BH 64, S 1024, D 128,
    # GQA 2, bf16): the trainable function's torch-ops backward, and
    # autograd's through the plain version, each on a kept graph
    q, k, v = layer0[torch.bfloat16]
    do = randn(bh, TRAIN_SEQ, d, dtype=torch.bfloat16)

    def backward_ms(fn, iters):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True, scale=1.0)
        return cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), iters)

    row["attention_backward"] = {
        "shape": [[bh, TRAIN_SEQ, d], [bh // g, TRAIN_SEQ, d]],
        "dtype": "bfloat16",
        "ms": backward_ms(FA.flash_attention_trainable, 10),
        "plain_autograd_ms": backward_ms(FA.flash_attention_plain, 5)}
    del layer0, q, k, v, do

    # -- rwkv6-3b at full width, 2 layers, through make_train_step -------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ocfg = O.AdamWConfig()
    params = T.init_model(seed, rcfg, "cuda")
    opt = O.init(params, ocfg)
    data = SyntheticLM(DataConfig(vocab=rcfg.vocab, seq_len=RWKV_TRAIN_SEQ,
                                  global_batch=RWKV_TRAIN_BATCH, seed=seed),
                       device="cuda")
    step_fn = St.make_train_step(rcfg, ocfg)
    rtimes, rlosses = [], []

    def rwkv_steps():
        nonlocal params, opt
        for s in range(RWKV_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, data.batch_at(s))
            rlosses.append(float(m["loss"]))
            rtimes.append((time.perf_counter() - t0) * 1e3)

    _, rcounts = run_path("rwkv6-3b train", ("gla_time_mix",), rwkv_steps)
    require(all(np.isfinite(rlosses)), f"rwkv6-3b train losses {rlosses}")
    chunks = -(-RWKV_TRAIN_SEQ // GLA.CHUNK)
    want = RWKV_TRAIN_STEPS * rcfg.n_layers * 2 * chunks
    require(rcounts["gla_time_mix"] == want,
            f"rwkv6-3b train: {rcounts['gla_time_mix']} gla_time_mix "
            f"launches, not {want} (a chunk, forward and recompute)")
    del params, opt
    torch.cuda.empty_cache()
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in gla0]
    y, st = GLA.gla_time_mix_trainable(*leaves)
    dy = randn(*y.shape)
    ins = [t for t in leaves if t is not None]
    row["rwkv6-3b"] = {
        "layers": rcfg.n_layers, "steps": RWKV_TRAIN_STEPS,
        "batch": RWKV_TRAIN_BATCH, "seq": RWKV_TRAIN_SEQ,
        "step_ms": rtimes, "losses": rlosses,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_launches": rcounts["gla_time_mix"],
        "gla_backward_ms": cuda_ms(lambda: torch.autograd.grad(
            y, ins, dy, retain_graph=True), 1),
        "gla_backward_shape": [list(t.shape) for t in ins]}
    del y, st, leaves, ins, gla0

    # -- preempt and resume of the reduced qwen3, compressed checkpoint --
    directory = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(directory, ignore_errors=True)
    base = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "32", "--ckpt-dir", directory, "--ckpt-every",
            "2", "--log-every", "1", "--ckpt-compress-eb", "1e-4", "--seed",
            str(seed)]

    def preempt():
        try:
            train.main(base + ["--preempt-at", "3"])
        except SystemExit as e:
            return e.code
        return 0

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        code, _ = run_path("train preempt", ("flash_attention",), preempt)
        resumed, rc = run_path("train resume", (
            "flash_attention", "count_subseq", "decode_tiles"),
            lambda: train.main(base))
    out = printed.getvalue()
    print(out, end="")
    require(code == 17, f"train --preempt-at 3 exited with {code}, not 17")
    after = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[train\] step=(\d+) loss=([-\d.naif]+)", out.split(
            "simulated preemption")[-1])}
    require("[train] resumed from step 3" in out and sorted(after) == [4, 5]
            and all(np.isfinite(x) for x in after.values()),
            f"train resume: {after}")
    row["preempt_resume"] = {
        "exit_code": code, "resumed_losses": after,
        "restore_launches": {k: rc[k] for k in ("count_subseq",
                                                "decode_tiles")},
        "steps": sorted(os.listdir(directory))}
    shutil.rmtree(directory, ignore_errors=True)
    row["phase_s"] = time.perf_counter() - t_phase
    print(f"train {json.dumps(row)}")
    return row


def run_naive_ref(results) -> dict:
    """``method="naive_ref"`` on the card: each field's payload decompressed
    by ``Codec(CodecConfig(method="naive_ref"))``, the whole stream in one
    sequential scan through the ``decode_chunked`` kernel (the stream as
    its one chunk, one thread), counts zeroed just before and read just
    after: one ``decode_chunked`` launch a field and no other kernel.  The
    output is held against the two-pass output and its codes against the
    gap decode's, bit for bit.  Prints and returns one ``naive_ref`` row."""
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import launches

    t_phase = time.perf_counter()
    codec = Codec(CodecConfig(method="naive_ref"))
    launches.reset()
    outs = {}
    for name, (_, c, _, _, _) in results.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = codec.decompress(c)
        torch.cuda.synchronize()
        outs[name] = (y, time.perf_counter() - t0)
    counts = launches.counts()
    print(f"naive_ref path launches: {json.dumps(counts)}")
    want = {"decode_chunked": len(results), **dequant_launches(
        c for _, c, _, _, _ in results.values())}
    for kname, n in counts.items():
        require(n == want.get(kname, 0),
                f"naive_ref path: kernel {kname} launched {n} times")
    fields = {}
    for name, (gcodec, c, y, _, _) in results.items():
        y2, secs = outs[name]
        require(y2.device.type == "cuda" and same(y2, y),
                f"{name}: naive_ref output differs from the two-pass output")
        codes = hp.decode_naive_ref(c.stream, c.codebook, c.n_symbols)
        gap = gcodec.decode(c.stream, c.codebook, c.n_symbols)
        require(same(codes, gap),
                f"{name}: naive_ref codes differ from the gap decode's")
        fields[name] = {"n_symbols": c.n_symbols, "decompress_s": secs,
                        "decode_gbps": c.quant_code_bytes / secs / 1e9}
    row = {"launches": counts["decode_chunked"], "fields": fields,
           "bit_equal_to_gap": True,
           "phase_s": time.perf_counter() - t_phase}
    print(f"naive_ref {json.dumps(row)}")
    return row


#: The archs whose traces are longest (rwkv6-3b's per-step GLA backward,
#: deepseek-v3's 8 micro-batches, zamba2-7b's chunk loop): queued first.
DRYRUN_HEAVY = ("rwkv6-3b", "deepseek-v3-671b", "zamba2-7b")
#: The dryrun phase's one-card cross-checks on a {data: 1, model: 1}
#: layout: the model phase's qwen3-0.6b prefill (B x S), and a qwen3-0.6b
#: decode step against a cache that outweighs the parameters (B x S).
CROSS_ARCH, CROSS_BATCH, CROSS_LEN = "qwen3-0.6b", 4, 1024
CROSS_DECODE_BATCH, CROSS_DECODE_LEN = 8, 8192
#: The predicted peak must lie within this factor of the card's.
CROSS_PEAK_FACTOR = 1.1


def _dryrun_worker_init():
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _dryrun_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """One dry-run cell (``launch/dryrun.run_cell``); a cell that raises is
    written with ``ok: false`` and its error, as the reference's
    orchestrator writes a failed one."""
    import traceback

    from repro_torch.launch import dryrun

    try:
        return dryrun.run_cell(arch, shape, multi_pod)
    except Exception:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "ok": False, "error": traceback.format_exc()[-2000:]}


def dryrun_cells() -> tuple:
    """Every cell of ``configs.cells()`` on both meshes (66), traced in a
    pool of ``os.cpu_count()`` spawned processes (train cells and the heavy
    archs first) while no card phase runs.  Returns ``(records, workers,
    wall seconds)``."""
    import multiprocessing

    from repro_torch import configs

    kinds = {"train": 0, "prefill": 1, "decode": 2}
    cells = sorted(((a, s, mp) for a, s, _ in configs.cells()
                    for mp in (False, True)),
                   key=lambda c: (kinds[configs.SHAPES[c[1]].kind],
                                  c[0] not in DRYRUN_HEAVY))
    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            workers, initializer=_dryrun_worker_init) as pool:
        records = pool.starmap(_dryrun_cell, cells, chunksize=1)
    return records, workers, time.perf_counter() - t0


def _card_peak(step, args, seed_bytes: int) -> tuple:
    """``(allocator peak, traced peak)`` of one ``step(*args)`` on the card
    above the ``seed_bytes`` allocated before its inputs were made: the
    allocator's ``max_memory_allocated``, and the peak of the storages the
    step makes as ``hlo_cost.StepCost`` follows them in this real run (the
    inputs held, as in the dry run), which splits a gap between the
    prediction and the allocator into the trace's ops and the allocator."""
    import torch

    from repro_torch.launch import hlo_cost

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated() - seed_bytes
    traced = hlo_cost.step_costs(step, *args)["peak_bytes"]
    torch.cuda.synchronize()
    return alloc, traced


def dryrun_cross_check(seed: int, kind: str) -> dict:
    """The dry run's figures for one qwen3-0.6b step on a ``{data: 1,
    model: 1}`` layout, held against the same step run for real on the
    card.  ``kind`` "prefill": B ``CROSS_BATCH`` x ``CROSS_LEN``, the
    ``flash_attention`` launches ``kernels/launches`` counts equal to the
    predicted.  "decode": one token at B ``CROSS_DECODE_BATCH`` against a
    cache of ``CROSS_DECODE_LEN`` (its bytes equal to the predicted, no
    kernel launched).  Both: parameter bytes exactly, the matrix FLOPs
    ``FlopCounterMode`` counts (the kernel is opaque to it, as to the
    trace, which counts it apart), and the predicted peak (parameters,
    cache, inputs and the step's own) within ``CROSS_PEAK_FACTOR`` of the
    allocator's, beside the peak the trace follows on the card; the
    roofline bound beside the measured step time."""
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.kernels import launches
    from repro_torch.launch import dryrun
    from repro_torch.models import decode as D
    from repro_torch.models import steps as St
    from repro_torch.models import transformer as T

    cfg = configs.get_config(CROSS_ARCH)
    if kind == "prefill":
        b, s = CROSS_BATCH, CROSS_LEN
    else:
        b, s = CROSS_DECODE_BATCH, CROSS_DECODE_LEN
    pred = dryrun.trace_cell(cfg, ShapeCell(f"smoke_{kind}", kind, s, b),
                             {"data": 1, "model": 1})
    mem = pred["mem"]

    gc.collect()
    torch.cuda.empty_cache()
    seed_bytes = torch.cuda.memory_allocated()
    params = T.init_model(seed, cfg, "cuda")
    gen = T.generator(seed + 11, "cuda")
    if kind == "prefill":
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        step = St.make_prefill_step(cfg)
        args = (params, tokens)
        cache_bytes = 0
    else:
        token = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                              device="cuda", dtype=torch.int32)
        cache = D.init_cache(cfg, b, s, "cuda")
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in cache.values())
        require(cache_bytes == mem["cache_bytes"],
                f"dryrun {kind} cross-check: cache bytes {cache_bytes} on "
                f"the card, {mem['cache_bytes']} predicted")
        step = St.make_serve_step(cfg)
        args = (params, token, cache, s - 1)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    require(param_bytes == mem["param_bytes"],
            f"dryrun {kind} cross-check: parameter bytes {param_bytes} on "
            f"the card, {mem['param_bytes']} predicted")
    step(*args)                     # warm-up: cuBLAS handles, the kernel
    torch.cuda.synchronize()
    launches.reset()
    step(*args)
    torch.cuda.synchronize()
    got = {k: n for k, n in launches.counts().items() if n}
    want = {k: r["launches"] for k, r in pred["cost"]["kernels"].items()}
    require(got == want, f"dryrun {kind} cross-check: launches {got} on "
            f"the card, {want} predicted")
    with FlopCounterMode(display=False) as counter:
        step(*args)
    real_flops = counter.get_total_flops()
    pred_flops = pred["cost"]["matrix_flops_per_device"]
    require(real_flops == pred_flops,
            f"dryrun {kind} cross-check: {real_flops} matrix FLOPs counted "
            f"on the card, {pred_flops} predicted")
    real_peak, traced_step = _card_peak(step, args, seed_bytes)
    pred_peak = (mem["param_bytes"] + mem.get("cache_bytes", 0)
                 + mem["input_bytes"] + mem["step_peak_bytes"])
    ratio = pred_peak / real_peak
    require(1 / CROSS_PEAK_FACTOR <= ratio <= CROSS_PEAK_FACTOR,
            f"dryrun {kind} cross-check: predicted peak {pred_peak} B is "
            f"{ratio:.3f}x the card's {real_peak} B")
    ms = cuda_ms(lambda: step(*args), 3)
    bound_ms = pred["roofline"]["bound_step_s"] * 1e3
    row = {"arch": CROSS_ARCH, "kind": kind, "batch": b, "seq": s,
           "layout": {"data": 1, "model": 1},
           "param_bytes": param_bytes, "cache_bytes": cache_bytes,
           "launches": got, "matrix_flops": real_flops,
           "kernel_flops": sum(r["flops"] for r in
                               pred["cost"]["kernels"].values()),
           "peak_bytes": real_peak, "predicted_peak_bytes": pred_peak,
           "peak_ratio": ratio,
           "predicted_step_peak_bytes": mem["step_peak_bytes"],
           "card_traced_step_peak_bytes": traced_step,
           "card_step_peak_bytes": real_peak - param_bytes - cache_bytes,
           "step_ms": ms, "bound_ms": bound_ms,
           "bound_dominant": pred["roofline"]["dominant"],
           "predicted_bytes": pred["cost"]["bytes_per_device"],
           "t_trace_s": pred["t_trace_s"]}
    del params, args, step
    gc.collect()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    print(f"dryrun {kind} cross-check: parameter bytes {param_bytes}"
          f"{f', cache bytes {cache_bytes}' if cache_bytes else ''} = "
          f"predicted, launches {got} = predicted, {real_flops} matrix "
          f"FLOPs = predicted; peak {real_peak / gib:.3f} GiB on the card, "
          f"{pred_peak / gib:.3f} predicted (ratio {ratio:.3f}); the step's "
          f"own {mem['step_peak_bytes'] / gib:.3f} GiB predicted, "
          f"{traced_step / gib:.3f} traced on the card, "
          f"{row['card_step_peak_bytes'] / gib:.3f} by the allocator; "
          f"{kind} {ms:.3f} ms against a roofline bound of {bound_ms:.3f} ms "
          f"({row['bound_dominant']})")
    return row


def run_dryrun(seed: int) -> dict:
    """The dryrun phase, after every other card phase: the 66 cells'
    records (:func:`dryrun_cells`; each must be ``ok``; a line a cell: the
    per-device peak, FLOPs, the dominant term and ``bound_step_s``),
    written as JSON lines to ``chiprun_out/dryrun_results.jsonl``, then the
    one-card cross-checks (:func:`dryrun_cross_check`, prefill and
    decode).  Prints and returns one ``dryrun`` row."""
    records, workers, cells_s = dryrun_cells()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "dryrun_results.jsonl"), "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    for rec in records:
        require(rec.get("ok"), f"dryrun cell {rec['arch']} x {rec['shape']} "
                f"multi_pod={rec['multi_pod']} failed: {rec.get('error')}")
        print(f"dryrun {rec['arch']} x {rec['shape']} mesh={rec['mesh']}: "
              f"peak {rec['mem']['peak_per_device_gib']} GiB/device, "
              f"{rec['cost']['flops_per_device']:.3e} flops/device, "
              f"coll {rec['collectives']['total'] / 2**20:.1f} MiB/device, "
              f"dominant={rec['roofline']['dominant']}, bound_step_s="
              f"{rec['roofline']['bound_step_s']:.4g} "
              f"(trace {rec['t_trace_s']} s)")
    require(len(records) == 66, f"dryrun: {len(records)} cells, not 66")
    t1 = time.perf_counter()
    cross = {kind: dryrun_cross_check(seed, kind)
             for kind in ("prefill", "decode")}
    row = {"cells": len(records), "ok": sum(bool(r.get("ok"))
                                            for r in records),
           "workers": workers, "cells_wall_s": cells_s,
           "trace_s_sum": sum(r["t_trace_s"] for r in records),
           "trace_s_max": max(r["t_trace_s"] for r in records),
           "cross_check": cross, "cross_check_s": time.perf_counter() - t1}
    print(f"dryrun {json.dumps(row)}")
    return row


#: The examples phase: each twin, its arguments on the card, and the lines
#: (substrings) its output must hold.
EXAMPLES = (
    ("quickstart_torch.py", (), (
        "decompress[gap       ]", "decompress[selfsync  ]",
        "decompress[naive_ref ]", "decompress[cuda-tuned]",
        "decompress_batch[4 shards]", "step passthrough 3")),
    ("kv_offload_paging_torch.py", (), ("paged 2 blocks out / 2 in",)),
    ("long_context_serve_torch.py", (), ("generated token matrix",)),
    ("train_e2e_torch.py", ("--steps", "60"), (": OK",)),
    ("compressed_checkpoint_torch.py", (), (
        "restore within error bound: OK", "continued training")),
    ("grad_compression_dp_torch.py", (), (
        "exact_f32", "compressed  :", "encode dispatches, 0 fallbacks")),
)
#: Lines an example's output must hold as many times as given.
EXAMPLE_OK_LINES = {"quickstart_torch.py": 3}
#: Seconds an example may take.
EXAMPLE_TIMEOUT = 300


def run_examples() -> dict:
    """The examples phase: the six ``examples/*_torch.py`` twins, each as
    its own process on the card (``grad_compression_dp_torch.py`` starts 8
    gloo ranks of its own), through a launcher that prints the process's
    kernel launch counts after the twin's ``main`` (its ranks' counts are
    their own).  Each must exit 0 and print its lines; the lines ending in
    OK are counted.  Prints and returns one ``examples`` row."""
    import tempfile

    t_phase = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, args, must in EXAMPLES:
            path = os.path.join(ROOT, "examples", name)
            argv = [path, *args]
            if name == "train_e2e_torch.py":
                argv += ["--ckpt-dir", os.path.join(tmp, "train_e2e")]
            code = ("import json, runpy, sys; sys.argv = " + repr(argv)
                    + "; runpy.run_path(sys.argv[0], run_name='__main__'); "
                    "from repro_torch.kernels import launches; "
                    "print('launches ' + json.dumps(launches.counts()))")
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=EXAMPLE_TIMEOUT)
            secs = time.perf_counter() - t0
            out = p.stdout
            require(p.returncode == 0,
                    f"example {name} exited {p.returncode}: "
                    f"{p.stderr[-2000:]}")
            for line in must:
                require(line in out, f"example {name} printed no "
                        f"{line!r}:\n{out[-2000:]}")
            ok_lines = [ln for ln in out.splitlines()
                        if ln.rstrip().endswith("OK")]
            require(len(ok_lines) >= EXAMPLE_OK_LINES.get(name, 0),
                    f"example {name}: {len(ok_lines)} OK lines")
            counts = json.loads(out.rsplit("launches ", 1)[1])
            rows[name] = {"s": secs, "ok_lines": len(ok_lines),
                          "launches": {k: n for k, n in counts.items()
                                       if n}}
            print(f"example {name}: exit 0 in {secs:.1f} s; "
                  + " | ".join(ln.strip() for ln in out.splitlines()
                               if not ln.startswith("launches ")))
    row = {"examples": rows, "phase_s": time.perf_counter() - t_phase}
    print(f"examples {json.dumps(row)}")
    return row


def profile_breakdown(fn, top: int = 6) -> dict:
    """One call of ``fn`` after a warm-up call, under ``torch.profiler``
    (``profile_once``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    return profile_once(fn, top)[1]


def profile_once(fn, top: int = 6) -> tuple:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA): ``(its
    result, stats)``, the stats its wall time (host clock, synchronized),
    the device time summed over the kernels it launched, their count, the
    device's idle share of the wall time, and the ``top`` kernels by device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
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
    return out, {"wall_ms": wall, "device_ms": device,
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

    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    secs = _build.build()
    print(f"build: {secs:.2f} s for {len(_build.SIGNATURES)} kernels "
          f"(nvcc, sm_90a, in parallel)")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return smoke(args, t_start)


def smoke(args, t_start: float) -> int:
    """Every phase after the build (``main``)."""
    import torch

    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.kernels.cost import HBM_BYTES_PER_S
    from repro_torch.core.sz import compressor, lorenzo
    from repro_torch.kernels import _build, launches, ops
    from repro_torch.kernels import huffman_decode as K

    t0 = time.perf_counter()
    fields = make_fields(args.seed)
    print(f"fields: {', '.join(f'{k} float32{list(v.shape)}' for k, v in fields.items())}"
          f" from seed {args.seed} in {time.perf_counter() - t0:.1f} s; "
          f"hacc1d is cut from HACC's {HACC_VALUES} values to {1 << 24}")

    xs = {k: torch.from_numpy(v).cuda() for k, v in fields.items()}
    torch.cuda.synchronize()

    # -- two-pass path: counts zeroed just before, read just after ----------
    results = {}
    read_launches = {}
    launches.reset()
    for name, x in xs.items():
        codec = Codec(CodecConfig())
        t0 = time.perf_counter()
        c = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = launches.counts()
        y = codec.decompress(c)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = launches.counts()
        read_launches[name] = {k: after[k] - before[k] for k in after}
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
    # The default read dequantizes in one epilogue launch: the 3-D field
    # through dequant_reconstruct_nd.
    for name, (_, c, _, _, _) in results.items():
        got = {k: read_launches[name][k] for k in DEQUANT_KERNELS}
        require(got == dequant_launches([c]),
                f"{name}: two-pass read launched {got}")
    require(read_launches["isabel3d"]["dequant_reconstruct_nd"] == 1,
            "isabel3d: the two-pass read did not dequantize in one "
            "dequant_reconstruct_nd launch")

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
        # The two-pass dequantize as a read runs it (on "cuda" the epilogue
        # and its input preparation).
        row["dequantize_ms"] = cuda_ms(
            lambda: compressor._dequantize(c, got, codec.backend), 10)
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
        row[ename]["torch_ops_ms"] = cuda_ms(
            lambda: lorenzo.dequantize(
                got.reshape(c.shape), c.outlier_pos, c.outlier_val, c.eb,
                c.shape, radius=c.radius, dtype=c.dtype), 10)
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

    naive = run_naive_ref(results)
    selfsync = run_selfsync(results)
    batch = run_batch(args.seed, results, xs)
    encode = run_encode(args.seed, xs)
    chunked = run_chunked(results, rows, selfsync)
    store = run_store(args.seed, xs)
    del xs, results, fused, padded, padded_fused, tuned
    torch.cuda.empty_cache()
    model = run_model(args.seed)
    families = run_families(args.seed)
    moe = run_moe(args.seed)
    mla = run_mla(args.seed)
    hybrid = run_hybrid(args.seed)
    trained = run_train(args.seed)
    pager = run_pager(args.seed)
    consumers = {"checkpoint": run_checkpoint(args.seed),
                 "faults": run_faults(), "serve": run_serve_kv(args.seed),
                 "loadgen": run_loadgen(args.seed),
                 "sharded": run_sharded(args.seed)}
    examples = run_examples()
    # last, so that its CPU traces share the host with no card phase
    dryrun = run_dryrun(args.seed)

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
    # The launches of the checkpoint, fault-campaign, serve (its three
    # runs) and load-generator paths, beside each row's main-path count.
    for i, kname in ((0, "count_subseq"), (1, "decode_tiles"),
                     (7, "lorenzo_quantize"), (9, "histogram"),
                     (10, "pack_tiles")):
        kernels[i]["consumer_launches"] = {
            "checkpoint": consumers["checkpoint"]["launches"][kname],
            "faults": consumers["faults"]["launches"][kname],
            "serve": sum(c[kname] for c in
                         consumers["serve"]["launches"].values()),
            "loadgen": consumers["loadgen"]["launches"][kname],
            "sharded": consumers["sharded"]["launches"][kname]
            + consumers["sharded"]["salvage_launches"][kname]}
    for kname, k in model["kernels"].items():
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "serve_launches": k["serve_launches"],
            "train_launches": trained[TRAIN_RUNS[kname]]["train_launches"],
            "train_backward_ms": (
                trained["attention_backward"]["ms"]
                if kname == "flash_attention"
                else trained["rwkv6-3b"]["gla_backward_ms"]),
            "shape": k["shape"],
            "dtype": k["dtype"], **{key: k[key] for key in (
                "decode_shape", "decode_ms", "decode_device_ms",
                "decode_bound_ms") if key in k}})
        if kname == "flash_attention":
            # the windowed shape (danube's layer 0) and the attention
            # families' prefill launches
            kernels[-1]["windowed"] = families["h2o-danube-1.8b"][
                "layer0_kernel"]
            kernels[-1]["family_launches"] = families["launches"]
            # qwen2-moe-a2.7b: its prefill's and its 2-layer training's
            # launches, and the kernel at its layer 0 (GQA 1)
            kernels[-1]["moe_launches"] = {
                "prefill": moe["prefill_launches"],
                "train": moe["train"]["train_launches"]}
            kernels[-1]["moe_layer0"] = moe["layer0_kernel"]
            # deepseek-v3-671b: its 4-layer prefill's and its 2-layer
            # gradient's launches, and the kernel at its layer 0 (D 192
            # over Dv 128)
            kernels[-1]["mla_launches"] = {
                "prefill": mla["prefill_launches"],
                "train": mla["train"]["train_launches"]}
            kernels[-1]["mla_layer0"] = mla["layer0_kernel"]
            # zamba2-7b: its full-depth prefill's and its 12-layer
            # gradient's launches, and the kernel at the shared block's
            # first invocation (D 112, window 4,096)
            kernels[-1]["hybrid_launches"] = {
                "prefill": hybrid["prefill_launches"],
                "train": hybrid["train"]["train_launches"]}
            kernels[-1]["hybrid_layer0"] = hybrid["layer0_kernel"]
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
        "chunk_symbols": CHUNK_SIZES[0], "fields_ms": k["fields_ms"],
        "naive_ref_launches": naive["launches"],
        "naive_ref_decompress_s": {f: r["decompress_s"]
                                   for f, r in naive["fields"].items()}})
    require(len(kernels) == len(REPLACES) + len(YARDSTICKS)
            == len(_build.SIGNATURES),
            f"{len(kernels)} kernel rows for {len(REPLACES)} TPU kernels, "
            f"{len(YARDSTICKS)} yardsticks and {len(_build.SIGNATURES)} "
            f"kernel libraries")
    print(f"table V {json.dumps(table_v(chunked))}")
    print(f"store and pager {json.dumps(store_summary(store, pager))}")
    print(f"consumers {json.dumps(consumer_summary(consumers))}")
    print(f"new phases {json.dumps({'naive_ref_s': naive['phase_s'], 'examples_s': examples['phase_s'], 'dryrun_cells_wall_s': dryrun['cells_wall_s'], 'dryrun_cross_check_s': dryrun['cross_check_s']})}")
    print(json.dumps({"kernels": kernels}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
