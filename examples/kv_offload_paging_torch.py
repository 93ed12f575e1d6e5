"""Page a serving KV cache through the compressed tensor store (PyTorch /
CUDA port).

    PYTHONPATH=src python examples/kv_offload_paging_torch.py [--device cpu]

The twin of ``examples/kv_offload_paging.py`` on ``repro_torch``, on the
card by default.  Prefills a reduced model, evicts the prompt KV blocks to
``.szt`` archives with ``repro_torch.store.KVPager``, demand-pages them
back, and keeps generating -- then reports the decode backend's counters,
where the plan cache shows up as plan builds.
"""

import argparse

from repro_torch.core.huffman import pipeline as hp
from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the model, cache and codec "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    out = serve.main([
        "--arch", "qwen3-0.6b", "--reduced",
        "--batch", "2", "--prompt-len", "16", "--gen-len", "8",
        "--kv-offload", "--kv-block", "8", "--kv-eb", "1e-3",
        "--device", args.device,
    ])
    assert out["tokens"].shape == (2, 9)
    stats = out["page_stats"]
    assert stats["pages_out"] == 2 and stats["pages_in"] == 2
    print(f"paged {stats['pages_out']} blocks out / {stats['pages_in']} in, "
          f"{stats['bytes_compressed']} stored bytes, "
          f"max err {out['kv_err']:.2e}")

    # Plan-cache effect: a fresh pager over the same data rebuilds plans on
    # the first page-in only (digest-keyed, so any equal-content block hits).
    be = hp.get_backend("cuda")
    print(f"decode backend issued "
          f"{be.stats['decode_write_dispatches']} decode-write dispatches, "
          f"{be.stats['plan_builds']} plan builds this run")
    print("OK")


if __name__ == "__main__":
    main()
