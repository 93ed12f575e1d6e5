"""Serving driver: batched autoregressive decode with optional compressed
KV-cache offload (the paper's in-memory compression use case made live).

Port of ``src/repro/launch/serve.py``, with its flags and flow: prompt
prefill (decode steps over the prompt) -> optionally compress the
prompt-phase cache with the SZ pipeline and restore it through the
optimized parallel Huffman decoder -> continue decoding.  Reports tokens/s,
cache compression ratio, and the decode-path error introduced; it prints
the same summary lines and returns the same dict.  ``--device`` (default
``cuda``) is the port's counterpart of JAX's platform choice; the weights,
the prompt and the cache are made on that device from ``--seed``.

``--kv-offload`` instead pages the prompt KV blocks *through the
compressed tensor store*: prefix blocks are evicted to ``.szt`` archives
(``repro_torch.store.KVPager``, which zeroes the evicted span in place) and
demand-paged back before generation; repeat page-ins of a block hit the
plan cache, so steady-state paging is pure phase-4 decode.  Page-in decodes
all blocks in one class-merged dispatch set; with ``--concurrency N`` the
blocks are instead requested by N concurrent decode streams through one
shared ``repro_torch.serving`` scheduler -- their requests coalesce within
``--batch-window`` and the shared prefix decodes exactly once; lane 0's
blocks are written into the cache in place.

Times are read after a device synchronize.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 32 --gen-len 32 --compress-kv --kv-eb 1e-3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --kv-offload --kv-block 16 --kv-offload-dir /tmp/kv_blocks
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --kv-offload --concurrency 8 --batch-window 0.002
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --compress-kv
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \\
      --reduced --device cpu --compress-kv --kv-backend ref
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --reduced --device cpu --kv-offload --kv-backend ref

deepseek-v3-671b (the mla_moe family) caches one ``latent`` tensor (the
MLA's ``[c_kv | k_rope]`` a layer and token) in place of ``k`` and ``v``;
``--compress-kv`` and ``--kv-offload`` take it as they take ``k`` and
``v``.  zamba2-7b (the hybrid_ssm family) caches each Mamba2 layer's
float32 ``ssm`` state beside the shared block's ``k`` and ``v`` (an entry
per invocation): ``--compress-kv`` takes the whole tree, ``--kv-offload``
pages ``k`` and ``v`` only (the state has no token axis).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.models import decode as D
from repro_torch.models import kvcache
from repro_torch.models import steps as S
from repro_torch.models import transformer as T


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_err(a, b) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def _prompt(cfg, batch, prompt_len, seed, device):
    """The prompt tokens, drawn from ``seed`` on ``device``."""
    return torch.randint(0, cfg.vocab, (batch, prompt_len),
                         generator=T.generator(seed, device), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--kv-len", type=int, default=None)
    ap.add_argument("--compress-kv", action="store_true")
    ap.add_argument("--kv-eb", type=float, default=None,
                    help="relative error bound for KV compression "
                         "(default: the CodecConfig default)")
    ap.add_argument("--kv-backend", default=None,
                    help="decode backend for KV restore ('cuda', 'ref'; "
                         "default: the CodecConfig default)")
    ap.add_argument("--kv-encode-backend", default=None,
                    help="encode backend for KV eviction/compression "
                         "('ref' host path, 'cuda' device write path; "
                         "default: the CodecConfig default)")
    ap.add_argument("--kv-offload", action="store_true",
                    help="page prompt KV blocks out to store archives and "
                         "demand-page them back before generation")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="tokens per offloaded KV block")
    ap.add_argument("--kv-offload-dir", default=None,
                    help="directory for KV block archives "
                         "(default: a temp dir)")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="with --kv-offload: number of concurrent decode "
                         "streams paging the prompt blocks back through one "
                         "shared serving scheduler (they share the hot "
                         "prefix, so its blocks decode once; 1 = direct "
                         "batched page-in, no scheduler)")
    ap.add_argument("--batch-window", type=float, default=0.002,
                    help="scheduler batching window in seconds: page-in "
                         "requests arriving within one window coalesce "
                         "into one class-merged decode dispatch set")
    ap.add_argument("--kv-recovery", default="raise",
                    choices=["raise", "skip", "zero_fill"],
                    help="recovery policy for lost/corrupt KV blocks: "
                         "'raise' aborts on PageLostError; 'skip'/"
                         "'zero_fill' keep serving degraded -- the lost "
                         "block's span stays zeroed and "
                         "stats['pages_lost'] counts it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the weights, cache and prompt "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    kv_len = args.kv_len or (args.prompt_len + args.gen_len)
    device = torch.device(args.device)

    # One configured codec drives every KV compression path of this run
    # (offload paging AND in-memory compress/restore): eb, bound mode,
    # decode method/backend, and the plan cache travel together.  Its
    # device is the cache's.
    from repro_torch.core import Codec, CodecConfig
    overrides = {k: v for k, v in (("eb", args.kv_eb),
                                   ("backend", args.kv_backend),
                                   ("encode_backend",
                                    args.kv_encode_backend),
                                   ("recovery", args.kv_recovery))
                 if v is not None}
    kv_codec = Codec(CodecConfig(device=str(device), **overrides))

    params = T.init_model(args.seed, cfg, device)
    serve = S.make_serve_step(cfg)
    prompt = _prompt(cfg, args.batch, args.prompt_len, args.seed, device)
    cache = D.init_cache(cfg, args.batch, kv_len, device)
    if cfg.family == "encdec":
        # cross-attention K/V from the (stubbed) encoder features: zero
        # frames, as the reference's serve.py makes them (so the decode's
        # cross-attention adds zero)
        enc = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                          dtype=cfg.cdt, device=device)
        cache.update(D.cross_cache(params, enc, cfg))

    # --- prefill by stepping the decoder over the prompt ------------------
    _sync(device)
    t0 = time.time()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = serve(params, prompt[:, t:t + 1], cache, t)
    _sync(device)
    t_prefill = time.time() - t0

    # --- optional KV paging through the compressed tensor store -----------
    ratio = None
    kv_err = 0.0
    page_stats = None
    if args.kv_offload:
        import tempfile

        from repro_torch.models.kvcache import (KVPager, offload_prefix,
                                                page_in_blocks_batched)
        from repro_torch.store import PageLostError

        # Only tensors with a kv_len sequence axis at axis 2 are pageable
        # (ssm/rwkv recurrent states have no token axis to evict).
        keys = [k for k in cache
                if k in ("k", "v", "latent", "k_scale", "v_scale")]
        offload_dir = args.kv_offload_dir or tempfile.mkdtemp(
            prefix="kv_blocks_")
        pager = KVPager(offload_dir, codec=kv_codec)
        # A copy: the offload zeroes the cache's tensors in place.
        snapshot = {k: cache[k].to(torch.float32, copy=True) for k in keys}
        _sync(device)
        t0 = time.time()
        cache, block_ids = offload_prefix(cache, pager, args.prompt_len,
                                          block_tokens=args.kv_block,
                                          keys=keys)
        _sync(device)
        t_out = time.time() - t0
        t0 = time.time()
        # Under a non-raise recovery policy a lost block (missing/corrupt
        # archive -> PageLostError, counted in stats["pages_lost"]) keeps
        # its span zeroed and serving continues degraded.
        lost: list = []
        on_lost = (None if args.kv_recovery == "raise"
                   else lambda bid, e: lost.append((bid, e)))
        sched_stats = None
        if args.concurrency > 1:
            # N concurrent decode streams page the same prompt blocks
            # through one shared scheduler: their requests coalesce into
            # class-merged ticks and each distinct block decodes once
            # (lane 0's results are installed into this process' cache).
            import threading

            from repro_torch.serving import DecodeScheduler

            results: dict = {}
            errors: list = []
            with DecodeScheduler(pager,
                                 batch_window_s=args.batch_window) as sched:
                def lane(lane_id: int):
                    futs = [(bid, sched.submit(lane_id, bid))
                            for bid in block_ids]
                    for bid, f in futs:
                        try:
                            tensors = f.result()
                            if lane_id == 0:
                                results[bid] = tensors
                        except PageLostError as e:
                            if lane_id != 0:
                                continue
                            if on_lost is None:
                                errors.append(e)
                            else:
                                lost.append((bid, e))

                lanes = [threading.Thread(target=lane, args=(i,))
                         for i in range(args.concurrency)]
                for th in lanes:
                    th.start()
                for th in lanes:
                    th.join()
                sched_stats = dict(sched.stats)
            if errors:
                raise errors[0]
            for bid, tensors in results.items():
                kvcache.install_block(cache, pager, bid, tensors)
        else:
            cache = page_in_blocks_batched(cache, pager, block_ids,
                                           on_lost=on_lost)
        _sync(device)
        t_in = time.time() - t0
        lost_ids = {bid for bid, _ in lost}
        paged = set()
        for bid in block_ids:
            if bid not in lost_ids:
                paged |= set(pager.block_meta(bid)["names"])
        for name in sorted(paged):
            kv_err = max(kv_err, _max_err(cache[name], snapshot[name]))
        del snapshot
        ratio = pager.ratio
        page_stats = dict(pager.stats)
        if sched_stats is not None:
            page_stats["scheduler"] = sched_stats
        page_stats["encode_dispatches"] = kv_codec.stats["encode_dispatches"]
        page_stats["encode_fallbacks"] = kv_codec.stats["encode_fallbacks"]
        print(f"[serve] kv offload: {len(block_ids)} blocks x "
              f"{args.kv_block} toks -> {offload_dir} "
              f"({pager.stats['bytes_raw']/2**20:.2f} MiB raw, "
              f"{pager.stats['bytes_compressed']/2**20:.2f} MiB stored, "
              f"ratio {ratio:.2f}x); page-out {t_out:.2f}s, "
              f"page-in {t_in:.2f}s, max err {kv_err:.2e}")
        if sched_stats is not None:
            print(f"[serve] kv scheduler: {args.concurrency} streams x "
                  f"{len(block_ids)} blocks = {sched_stats['requests']} "
                  f"requests -> {sched_stats['batch_dispatches']} batched "
                  f"dispatches ({sched_stats['blocks_decoded']} blocks "
                  f"decoded once; prefix_hits="
                  f"{sched_stats['prefix_hits']}, coalesced="
                  f"{sched_stats['coalesced_requests']})")
        if lost:
            print(f"[serve] kv paging DEGRADED: {len(lost)} block(s) lost "
                  f"(pages_lost={pager.stats['pages_lost']}); their token "
                  f"spans stay zeroed")

    # --- optional cache compress/restore round trip ------------------------
    if args.compress_kv:
        skip = tuple(k for k in cache if k in ("xk", "xv"))
        cc = kvcache.compress_cache(
            {k: v for k, v in cache.items()}, codec=kv_codec, skip=skip)
        restored = kvcache.decompress_cache(cc, codec=kv_codec)
        for name, arr in restored.items():
            kv_err = max(kv_err, _max_err(arr, cache[name]))
            cache[name] = arr
        ratio = cc.ratio
        print(f"[serve] kv cache compressed {cc.original_bytes/2**20:.1f} MiB"
              f" -> {cc.compressed_bytes/2**20:.1f} MiB "
              f"(ratio {ratio:.2f}x, max err {kv_err:.2e})")

    # --- generation ---------------------------------------------------------
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out_tokens = [tok]
    _sync(device)
    t0 = time.time()
    for t in range(args.prompt_len, args.prompt_len + args.gen_len):
        logits, cache = serve(params, tok, cache, t)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(device)
    t_gen = time.time() - t0
    toks = args.batch * args.gen_len
    print(f"[serve] prefill {args.prompt_len} toks in {t_prefill:.2f}s; "
          f"generated {toks} tokens in {t_gen:.2f}s "
          f"({toks / max(t_gen, 1e-9):.1f} tok/s)")
    return {"ratio": ratio, "kv_err": kv_err, "page_stats": page_stats,
            "tokens": torch.cat(out_tokens, dim=1).to(torch.int32)
            .cpu().numpy()}


if __name__ == "__main__":
    main()
