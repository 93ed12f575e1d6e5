"""Error-bounded compressed checkpoints (PyTorch / CUDA port): save a
trained model with SZ-compressed float shards, restore, verify the bound,
keep training.

    PYTHONPATH=src python examples/compressed_checkpoint_torch.py [--device cpu]

The twin of ``examples/compressed_checkpoint.py`` on ``repro_torch``, on
the card by default: the port's ``CheckpointManager`` with a codec whose
write path runs on the device (``encode_backend="cuda"``: the quantize,
histogram and bit-pack kernels) and whose restore runs the decode kernels.
The trees are saved in the reference's layout (``convert.stack_layers``:
a leaf a parameter of all layers), as ``launch/train.py`` saves them, so
the bound is checked over the reference's leaves.
"""

import argparse
import os
import tempfile

import torch
import torch.utils._pytree as pytree

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import Codec, CodecConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import convert
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _keyed(tree) -> list:
    leaves, _ = pytree.tree_flatten_with_path(tree)
    return sorted(((pytree.keystr(k), v) for k, v in leaves),
                  key=lambda kv: kv[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the model, data and codec "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = configs.get_config("qwen3-0.6b").reduced()
    ocfg = adamw.AdamWConfig(lr=1e-3)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=4), device=dev)
    step = S.make_train_step(cfg, ocfg)
    params = T.init_model(0, cfg, dev)
    opt = adamw.init(params, ocfg)
    for s in range(10):
        params, opt, m = step(params, opt, data.batch_at(s))
    print(f"trained 10 steps, loss {float(m['loss']):.3f}")

    with tempfile.TemporaryDirectory() as d:
        codec = Codec(CodecConfig(eb=1e-4, encode_backend="cuda", device=dev))
        mgr = CheckpointManager(d, codec=codec, compress_min_size=4096)
        stacked = convert.sorted_tree(convert.stack_layers(params))
        mgr.save(9, stacked, convert.opt_state_stacked(opt))
        size = _dir_bytes(d)
        raw = sum(t.numel() * t.element_size()
                  for tree in (params, opt) for t in adamw.tree_leaves(tree))
        print(f"checkpoint {size / 2**20:.1f} MiB vs raw {raw / 2**20:.1f} "
              f"MiB ({raw / size:.2f}x)")
        r = mgr.restore()
        for (ka, a), (kb, b) in zip(_keyed(stacked), _keyed(r["params"])):
            assert ka == kb, (ka, kb)
            a32, b32 = a.to(torch.float32), b.to(torch.float32).to(a.device)
            err = float((a32 - b32).abs().max())
            rng_ = float(a32.max() - a32.min())
            assert err <= max(1e-4 * rng_ * 1.02, 1e-7), (ka, err)
        print("restore within error bound: OK")
        p2 = convert.unstack_layers(r["params"])
        o2 = {"m": convert.unstack_layers(r["opt"]["m"]),
              "v": convert.unstack_layers(r["opt"]["v"]),
              "step": r["opt"]["step"]}
        for s in range(10, 13):
            p2, o2, m = step(p2, o2, data.batch_at(s))
        print(f"continued training, loss {float(m['loss']):.3f}: OK")


if __name__ == "__main__":
    main()
