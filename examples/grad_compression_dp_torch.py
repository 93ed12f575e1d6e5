"""Gradient compression over an explicit data-parallel group (PyTorch /
CUDA port).

    PYTHONPATH=src python examples/grad_compression_dp_torch.py [--steps N] [--device cpu]

The twin of ``examples/grad_compression_dp.py`` on ``repro_torch``.  The
reference runs 8 data shards on 8 forced host devices of one process; a
torch data-parallel group is one process a rank, so this runs 8 ranks
(``--ranks``) in spawned processes on the host, joined over gloo (a
``FileStore`` in a temporary directory): a collective of 8 ranks cannot be
NCCL on one card.  Each rank computes its shard's loss and gradient on
``--device`` (the card by default), and the ranks sync the gradients on
the host with the bf16-reduce-scatter + int8-all-gather wire format with
error feedback (``runtime/collectives.py``), against an exact float32 mean.
Rank 0 reports both loss trajectories and the wire-byte saving, then
SZ-compresses the gradient history through a device-encode ``Codec``
(``CodecConfig(encode_backend="cuda")``: the quantize, histogram and
bit-pack kernels, the write path the KV pager and checkpoint shards use)
and reports the ratio and the encode counters.
"""

import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DIM = 512


def _data_for(shard: int, step: int, w_true, device):
    gen = torch.Generator().manual_seed(7919 * (7 * shard + 1) + step)
    x = torch.randn((64, DIM), generator=gen)
    y = x @ w_true + 0.01 * torch.randn((64,), generator=gen)
    return x.to(device), y.to(device)


def _local_loss(w, x, y):
    return torch.mean((x @ w - y) ** 2)


def _worker(rank: int, n: int, store_path: str, steps: int, device: str):
    from repro_torch.core import Codec, CodecConfig
    from repro_torch.core.sz.compressor import Compressed
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import collectives as C

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        mesh = make_host_mesh(data=n, device_type="cpu")
        group = mesh.get_group("data")
        w_true = torch.randn((DIM,), generator=torch.Generator()
                             .manual_seed(0))
        sync, init_res = C.make_dp_gradient_sync(mesh, eb=1e-6)

        g_hist = []
        for scheme in ("exact_f32", "compressed"):
            w = torch.zeros((DIM,), device=device)
            res = init_res({"w": torch.zeros((DIM,))})
            losses = []
            for step in range(steps):
                x, y = _data_for(rank, step, w_true, device)
                wg = w.detach().requires_grad_(True)
                loss = _local_loss(wg, x, y)
                (g,) = torch.autograd.grad(loss, wg)
                g = g.cpu()
                if scheme == "exact_f32":
                    dist.all_reduce(g, group=group)
                    g = g / n
                else:
                    out, res = sync({"w": g}, res)
                    gathered = [torch.empty_like(g) for _ in range(n)]
                    dist.all_gather(gathered, g, group=group)
                    g_hist.append(torch.stack(gathered))
                    g = out["w"]
                w = w - 0.05 * g.to(device)
                ls = loss.detach().cpu().reshape(1)
                dist.all_reduce(ls, group=group)
                losses.append(float(ls) / n)
            if rank == 0:
                print(f"{scheme:12s}: loss {losses[0]:.4f} -> "
                      f"{losses[-1]:.6f}", flush=True)
        if rank != 0:
            return

        print(f"wire bytes/param/step: fp32 all-reduce="
              f"{C.wire_bytes(DIM, 'allreduce_f32') / DIM:.1f}  "
              f"compressed={C.wire_bytes(DIM, 'rs_bf16_ag_int8') / DIM:.1f}  "
              f"({C.wire_bytes(DIM, 'allreduce_f32') / C.wire_bytes(DIM, 'rs_bf16_ag_int8'):.2f}x less traffic)")

        # --- SZ-compress the gradient history through the device write
        # path: quantize -> histogram -> bit-pack stay on the device; only
        # the 1024-entry histogram crosses to the host for the codebook.
        g_last = {"w": torch.stack(g_hist).to(device)}
        codec = Codec(CodecConfig(eb=1e-3, encode_backend="cuda",
                                  device=device))
        codec.reset_stats()
        ctree = codec.compress_tree(g_last)
        leaves = [c for c in ctree.values() if isinstance(c, Compressed)]
        raw = sum(c.original_bytes for c in leaves)
        stored = sum(c.compressed_bytes for c in leaves)
        restored = codec.decompress_tree(ctree)
        err = max(float((restored[k] - g_last[k]).abs().max())
                  for k in g_last)
        st = codec.stats
        print(f"grad tree via encode_backend='cuda': {raw} B -> {stored} B "
              f"(ratio {raw / max(stored, 1):.2f}x, max err {err:.2e}; "
              f"{st['encode_dispatches']} encode dispatches, "
              f"{st['encode_fallbacks']} fallbacks)", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60,
                    help="optimizer steps per scheme (default 60)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="data-parallel ranks, a process each (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="where the gradients and the codec run "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to run on the host")
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_worker, args=(args.ranks, os.path.join(d, "store"),
                                args.steps, args.device),
                 nprocs=args.ranks, join=True)


if __name__ == "__main__":
    main()
