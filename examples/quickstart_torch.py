"""Quickstart (PyTorch / CUDA port): compress a scientific field,
decompress it three ways.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch``, on the card by
default.  All policy lives in one ``CodecConfig``: the error bound on the
encode side, the sync method / decode strategy / backend on the decode
side.  A ``Codec`` is the configured session -- it also caches phase 1-3
decoder plans by content digest, so decoding the same tensor twice only
pays the decode-write phase the second time.  ``backend="cuda"`` (the
hand-written kernels) stands for the reference's ``"pallas"``; with
``--device cpu`` the kernel wrappers run their plain versions.
"""

import argparse

import torch

from repro_torch.core.api import Codec, CodecConfig
from repro_torch.data.pipeline import smooth_field


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the codec runs (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device

    def field(shape, seed):
        return torch.from_numpy(smooth_field(shape, seed=seed)).to(dev)

    # A Lorenzo-predictable "simulation snapshot".
    x = field((512, 512), 0)
    print(f"input: {tuple(x.shape)} float32, "
          f"{x.numel() * x.element_size() / 2**20:.1f} MiB")

    codec = Codec(CodecConfig(device=dev))  # eb 1e-3 relative, gap-array
    c = codec.compress(x)
    print(f"compressed: {c.compressed_bytes / 2**20:.2f} MiB "
          f"(ratio {c.ratio:.2f}x, eb {c.eb:.3e})")

    for method in ("gap", "selfsync", "naive_ref"):
        xh = Codec(CodecConfig(method=method, device=dev)).decompress(c)
        err = float((xh - x).abs().max())
        print(f"decompress[{method:10s}]: max err {err:.3e} "
              f"(bound {c.eb_effective:.3e}) "
              f"{'OK' if err <= c.eb_effective else 'VIOLATION'}")

    # kernel path (the CUDA kernels) with the online tuner's per-CR-class
    # tiles: one config, no flag soup.
    tuned = Codec(CodecConfig(backend="cuda", strategy="tuned", device=dev))
    xh = tuned.decompress(c)
    print(f"decompress[cuda-tuned]: max err "
          f"{float((xh - x).abs().max()):.3e}")

    # batched multi-tensor decode: one decode-write dispatch per CR class
    # across all tensors (how checkpoint shards / KV blocks restore).
    shards = [codec.compress(field((128, 512), s)) for s in range(4)]
    codec.reset_stats()
    outs = codec.decompress_batch(shards)
    err = max(float((o - field((128, 512), s)).abs().max())
              for s, o in enumerate(outs))
    print(f"decompress_batch[4 shards]: "
          f"{codec.stats['decode_write_dispatches']} class dispatches, "
          f"max err {err:.3e}")

    # pytree round trip: Compressed leaves in, decoded tensors out.
    tree = {"layer0": {"w": field((256, 64), 7)},
            "step": torch.tensor(3, dtype=torch.int32)}
    back = codec.decompress_tree(codec.compress_tree(tree))
    err = float((back["layer0"]["w"] - tree["layer0"]["w"]).abs().max())
    print(f"compress_tree/decompress_tree: max err {err:.3e}, "
          f"step passthrough {int(back['step'])}")


if __name__ == "__main__":
    main()
