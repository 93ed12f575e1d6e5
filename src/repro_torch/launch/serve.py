"""Serving launcher: batched greedy decode of a random prompt.

Port of ``src/repro/launch/serve.py``, with its flags and flow: prefill by
stepping the decoder over the prompt, then greedy generation; it prints the
same summary line and returns the same dict.  ``--device`` (default
``cuda``) is the port's counterpart of JAX's platform choice; the weights
and the prompt are drawn on that device from ``--seed``.  The compressed-KV
options ``--compress-kv``, ``--kv-recovery`` other than ``raise`` and
``--kv-offload`` come with ``models/kvcache.py`` (ROADMAP A10), which
rides on the ported codec trees and ``repro_torch.store.KVPager``;
``--concurrency`` above 1 with the serving scheduler (A8).  They raise
``NotImplementedError``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 32 --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.models import decode as D
from repro_torch.models import steps as S
from repro_torch.models import transformer as T


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
                         "(with --compress-kv)")
    ap.add_argument("--kv-backend", default=None,
                    help="decode backend for KV restore (with --compress-kv)")
    ap.add_argument("--kv-encode-backend", default=None,
                    help="encode backend for KV compression (with "
                         "--compress-kv)")
    ap.add_argument("--kv-offload", action="store_true",
                    help="page prompt KV blocks out to store archives and "
                         "demand-page them back before generation")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="tokens per offloaded KV block")
    ap.add_argument("--kv-offload-dir", default=None,
                    help="directory for KV block archives")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="with --kv-offload: concurrent decode streams "
                         "through one shared serving scheduler")
    ap.add_argument("--batch-window", type=float, default=0.002,
                    help="scheduler batching window in seconds")
    ap.add_argument("--kv-recovery", default="raise",
                    choices=["raise", "skip", "zero_fill"],
                    help="recovery policy for lost/corrupt KV blocks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the weights, cache and prompt "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    if args.compress_kv:
        raise NotImplementedError("--compress-kv is not ported yet: ROADMAP "
                                  "A10 (models/kvcache.py over "
                                  "Codec.compress_tree)")
    if args.kv_recovery != "raise":
        raise NotImplementedError("--kv-recovery other than 'raise' is not "
                                  "ported yet: ROADMAP A10 (models/"
                                  "kvcache.py's paging over KVPager)")
    if args.kv_offload:
        raise NotImplementedError("--kv-offload is not ported yet: ROADMAP "
                                  "A10 (models/kvcache.py's offload over "
                                  "KVPager)")
    if args.concurrency > 1:
        raise NotImplementedError("--concurrency > 1 is not ported yet: "
                                  "ROADMAP A8 (the serving scheduler)")

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    kv_len = args.kv_len or (args.prompt_len + args.gen_len)
    device = torch.device(args.device)

    params = T.init_model(args.seed, cfg, device)
    serve = S.make_serve_step(cfg)
    gen = T.generator(args.seed, device)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    cache = D.init_cache(cfg, args.batch, kv_len, device)

    # --- prefill by stepping the decoder over the prompt ------------------
    _sync(device)
    t0 = time.time()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = serve(params, prompt[:, t:t + 1], cache, t)
    _sync(device)
    t_prefill = time.time() - t0

    # --- generation ---------------------------------------------------------
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out_tokens = [tok]
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
    return {"ratio": None, "kv_err": 0.0, "page_stats": None,
            "tokens": torch.cat(out_tokens, dim=1).to(torch.int32)
            .cpu().numpy()}


if __name__ == "__main__":
    main()
