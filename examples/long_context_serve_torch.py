"""Serve with a compressed KV cache (PyTorch / CUDA port).

    PYTHONPATH=src python examples/long_context_serve_torch.py [--device cpu]

The twin of ``examples/long_context_serve.py`` on ``repro_torch``, on the
card by default.  Runs a sliding-window (h2o-danube-style) reduced model,
prefills a prompt, SZ-compresses the cache, restores it through the
parallel Huffman decoder's kernels, and keeps generating.
"""

import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the model, cache and codec "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    out = serve.main([
        "--arch", "h2o-danube-1.8b", "--reduced",
        "--batch", "2", "--prompt-len", "48", "--gen-len", "32",
        "--compress-kv", "--kv-eb", "5e-3",
        "--device", args.device,
    ])
    assert out["tokens"].shape == (2, 33)
    print("generated token matrix:", out["tokens"].shape, "OK")


if __name__ == "__main__":
    main()
