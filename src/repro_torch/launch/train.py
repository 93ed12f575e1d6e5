"""Training launcher: reduced configs run end to end on one device; the full
configs take the same code path.

Port of ``src/repro/launch/train.py``, with its flags and output lines:

  * deterministic sharded data (``SyntheticLM``; skip-ahead resume)
  * checkpoint/restart (atomic, optionally SZ-compressed): the parameters
    and AdamW's ``m``/``v`` are saved in the reference's layout
    (``convert.stack_layers``, the reference's entry names, in its key
    order), so each package resumes the other's checkpoints
  * ``--ckpt-sharded``: the mesh-sharded layout, restored through
    ``make_host_mesh()`` and ``CheckpointManager.restore(mesh=)``; the loop
    trains on full tensors, so each restored ``DTensor`` is gathered
    (``full_tensor``)
  * simulated preemption (``--preempt-at N`` exits with 17 after step N;
    rerunning resumes)

``--device`` (default ``cuda``) is where the weights, the optimizer state
and the batches live; on the card the attention of the dense, vlm, moe,
mla_moe and encdec families and of hybrid_ssm's shared block runs the
``flash_attention`` kernel and the rwkv family's time-mix
``gla_time_mix``, each inside its ``torch.autograd.Function``;
hybrid_ssm's Mamba2 layers run torch ops (the reference's are jnp); the
moe and mla_moe families' loss adds the router's aux loss, and
deepseek-v3's its MTP head's weighted CE.  A step's time is read after a
device synchronize.  The ``vlm`` and ``encdec`` families get the
reference's modality stubs in each batch (``extra_embeds``): 8 zero patch
embeddings for vlm, its labels left-padded by -1 over them, and
``encoder_seq`` zero frames for encdec.  Every family of the reference
trains.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
      --reduced --steps 6 --batch 2 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
      --reduced --steps 6 --batch 2 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \\
      --reduced --steps 6 --batch 2 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --reduced --steps 6 --batch 2 --seq 32 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import convert
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _full(tree):
    """``tree`` with each ``DTensor`` leaf gathered into a full tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-compress-eb", type=float, default=None)
    ap.add_argument("--ckpt-sharded", action="store_true",
                    help="write checkpoints in the mesh-sharded layout "
                         "(docs/distributed.md) and restore directly into "
                         "the host mesh's shardings")
    ap.add_argument("--ckpt-shards", type=int, default=None,
                    help="shard archives per sharded checkpoint "
                         "(default: one per process)")
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="simulate preemption: exit(17) after this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--opt-int8", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the weights, optimizer state and "
                         "batches (default: cuda)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    T.check_family(cfg)
    device = torch.device(args.device)
    ocfg = adamw.AdamWConfig(
        lr=args.lr, state_dtype="int8" if args.opt_int8 else "float32")

    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed), device=device)

    ckpt_codec = None
    if args.ckpt_compress_eb is not None or args.ckpt_sharded:
        from repro_torch.core import Codec, CodecConfig
        # Sharded layout compresses per tile; default eb if none was given.
        ckpt_codec = Codec(CodecConfig(eb=args.ckpt_compress_eb or 1e-4,
                                       device=str(device)))
    mgr = (CheckpointManager(args.ckpt_dir, codec=ckpt_codec, device=device)
           if args.ckpt_dir else None)
    ckpt_mesh = None
    if args.ckpt_sharded:
        from repro_torch.launch.mesh import make_host_mesh
        ckpt_mesh = make_host_mesh(device_type=device.type)

    start_step = 0
    params = opt_state = None
    if mgr is not None:
        restored = mgr.restore(mesh=ckpt_mesh)
        if restored is not None:
            params = convert.unstack_layers(_full(restored["params"]))
            opt = _full(restored["opt"])
            opt_state = {"m": convert.unstack_layers(opt["m"]),
                         "v": convert.unstack_layers(opt["v"]),
                         "step": opt["step"]}
            start_step = restored["step"] + 1
            print(f"[train] resumed from step {restored['step']}")

    if params is None:
        params = T.init_model(args.seed, cfg, device)
        opt_state = adamw.init(params, ocfg)

    step_fn = S.make_train_step(cfg, ocfg, n_micro=args.n_micro)

    def save(step):
        mgr.save(step, convert.sorted_tree(convert.stack_layers(params)),
                 convert.opt_state_stacked(opt_state), mesh=ckpt_mesh,
                 shard_count=args.ckpt_shards)

    losses = []
    _sync(device)
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = data.batch_at(step)
        if cfg.family in ("vlm", "encdec"):
            extra_len = 8 if cfg.family == "vlm" else cfg.encoder_seq
            batch = dict(batch)
            batch["extra_embeds"] = torch.zeros(
                (args.batch, extra_len, cfg.d_model), dtype=cfg.cdt,
                device=device)
            if cfg.family == "vlm":
                labels = batch["labels"]
                batch["labels"] = torch.cat(
                    [torch.full((args.batch, extra_len), -1,
                                dtype=labels.dtype, device=device), labels],
                    dim=1)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            _sync(device)
            dt = (time.time() - t0) / max(len(losses), 1)
            print(f"[train] step={step} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt*1000:.0f} ms/step)", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            save(step)
        if args.preempt_at is not None and step == args.preempt_at:
            print(f"[train] simulated preemption at step {step}")
            sys.exit(17)

    if mgr is not None:
        save(args.steps - 1)
    first, last = losses[0], sum(losses[-5:]) / min(len(losses), 5)
    print(f"[train] done: first loss {first:.4f} -> last(avg5) {last:.4f}")
    return first, last


if __name__ == "__main__":
    main()
