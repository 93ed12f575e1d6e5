"""Multi-pod dry run: trace every (arch x shape x mesh) cell on ``meta``.

Port of ``src/repro/launch/dryrun.py``.  The reference AOT-compiles each
cell's train / prefill / serve step on 512 forced host devices and reads
XLA's memory and cost analyses and the partitioned HLO.  Torch has no
compiler that does that, so the port's dry run is a meta-device trace: the
port's own step functions (``models/steps.py``) run once on ``meta``
tensors (shapes and dtypes, no data, no device) under
``launch/hlo_cost.StepCost``, which counts FLOPs, bytes, kernel launches
and live memory.  No process group is made: the production mesh is a
layout, ``{"data": 16, "model": 16}`` or with ``"pod": 2``, and the
per-device figures come from the port's sharding rules
(``runtime/sharding.py``) over that layout:

  * parameter, optimizer-state and cache bytes a device: each leaf's shard
    under ``param_shardings`` / ``opt_state_shardings`` /
    ``cache_shardings`` over ``init_model(..., "meta")``;
  * the step runs at the local batch (the global batch over the batch
    axes, as ``batch_shardings`` cuts it) with the model at full width;
    its FLOPs and bytes a device are the local counts over the model-axis
    size, which assumes an even tensor-parallel split;
  * its live-memory peak a device weighs each storage the step makes by a
    device's share (``hlo_cost.StepCost``).  A storage made for a parameter
    or optimizer-state leaf, found by identity (a gradient or an
    accumulator, which the train step names through
    ``kernels.cost.derived``; a cast or elementwise update of a leaf; a
    leaf of the step's new parameter and state trees), takes that leaf's
    shard.  An activation takes :func:`activation_share`: the residual
    stream (token vectors of width ``d_model``) whole, as the batch-only
    activation sharding of ``runtime/sharding.py`` leaves it on every
    device of the model axis, anything else one over the model-axis size.
    The inputs (the state above, the local batch) are added whole, and
    views of them and writes into them are not counted again.  The step
    returns new parameter and state trees where the reference donates its
    inputs, so the peak of a train step holds both;
  * collectives are reckoned from the sharding rules (``collective_bytes``,
    labelled "analytic"): there is no partitioned HLO to parse.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
                                       # orchestrates one subprocess per cell
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch
import torch.utils._pytree as pytree

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.distributed import partition as pt
from repro_torch.kernels import cost
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import decode as D
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, count_params
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd

#: The card the roofline is taken against: NVIDIA H100 SXM5 80GB, its
#: published peaks: dense bf16 tensor-core FLOP/s and HBM3 bytes/s (from
#: ``kernels/cost.py``, which bounds the kernels by the same figures), and
#: NVLink 4 bytes/s a direction (900 GB/s both ways, datasheet).
H100 = {"flops_bf16": cost.PEAK_FLOPS["bfloat16"],
        "hbm_gbs": cost.HBM_BYTES_PER_S, "link_gbs": 450e9}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: The production layouts (``launch/mesh.make_production_mesh``'s shapes).
MESH = {"data": 16, "model": 16}
MULTI_POD_MESH = {"pod": 2, "data": 16, "model": 16}


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def _prod(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def sds(shape, dtype):
    """A ``meta`` tensor: the port's ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell) -> dict:
    """Abstract inputs for one shape cell (the paper-spec'd entry point)."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            from repro_torch.configs.qwen2_vl_72b import N_PATCHES
            text = s - N_PATCHES
            batch = {
                "tokens": sds((b, text), torch.int32),
                "labels": sds((b, s), torch.int32),
                "extra_embeds": sds((b, N_PATCHES, cfg.d_model), cfg.cdt),
            }
        elif cfg.family == "encdec":
            batch = {
                "tokens": sds((b, s), torch.int32),
                "labels": sds((b, s), torch.int32),
                "extra_embeds": sds((b, cfg.encoder_seq, cfg.d_model),
                                    cfg.cdt),
            }
        else:
            batch = {
                "tokens": sds((b, s), torch.int32),
                "labels": sds((b, s), torch.int32),
            }
        return batch
    if cell.kind == "decode":
        cache = {k: sds(shape, dt)
                 for k, (shape, dt) in D.cache_spec(cfg, b, s).items()}
        return {
            "token": sds((b, 1), torch.int32),
            "cache": cache,
            "pos": sds((), torch.int32),
        }
    raise ValueError(cell.kind)


def opt_config(cfg: ModelConfig) -> adamw.AdamWConfig:
    big = count_params(cfg) > 5e10
    return adamw.AdamWConfig(state_dtype="int8" if big else "float32")


def micro_batches(cfg: ModelConfig) -> int:
    """Gradient-accumulation factor per arch (the reference's choice, kept
    so both packages split the same batches)."""
    n = count_params(cfg)
    if n > 3e11:
        return 8
    if n > 5e10:
        return 4
    if n > 8e9:
        return 2
    return 1


# ---------------------------------------------------------------------------
# Per-device bytes from the sharding rules
# ---------------------------------------------------------------------------


def _shard_fraction(sharding, shape, sizes) -> float:
    """The share of a tensor of ``shape`` one device holds."""
    return 1.0 / _prod(pt.spec_parts(sharding.spec, tuple(shape), sizes))


def _leaves(tree) -> list:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def leaf_shares(tree, shardings, layout) -> list:
    """``(leaf, a device's share of it)`` for each tensor leaf of ``tree``
    under ``shardings``."""
    sizes = pt.axis_sizes_of(layout)
    return [(t, _shard_fraction(s, t.shape, sizes))
            for t, s in zip(_leaves(tree), pytree.tree_leaves(shardings))]


def _owned_bytes(pairs) -> int:
    """Bytes one device holds of the ``(tensor, share)`` pairs."""
    return int(sum(t.numel() * t.element_size() * share
                   for t, share in pairs))


def _device_bytes(tree, shardings, layout) -> int:
    """Bytes of ``tree`` one device holds under ``shardings``."""
    return _owned_bytes(leaf_shares(tree, shardings, layout))


def param_bytes_per_device(params, layout) -> int:
    """Parameter bytes one device holds: each leaf's shard under
    ``param_shardings``."""
    return _device_bytes(params, shd.param_shardings(params, layout),
                         layout)


def local_batch(cell, cfg: ModelConfig, layout) -> int:
    """The global batch over the batch axes, as ``batch_shardings`` cuts
    the tokens (an indivisible batch stays whole)."""
    tokens = input_specs(cfg, cell)
    tokens = tokens["tokens"] if "tokens" in tokens else tokens["token"]
    spec = shd.batch_shardings(tokens, layout).spec
    parts = pt.spec_parts(spec, tuple(tokens.shape),
                          pt.axis_sizes_of(layout))
    return cell.global_batch // parts[0]


def activation_share(cfg: ModelConfig, tp: int):
    """A device's share of an activation (a storage the step makes that no
    leaf owns): 1 for the residual stream, a tensor of two or more
    dimensions whose last is ``d_model`` (the batch-only activation rule
    keeps it whole on each device of the model axis), except the routed
    families' per-expert buffers (leading dimension ``n_experts``, split
    over the model axis with the experts); ``1 / tp`` for anything else
    (heads, ``d_ff``, experts and vocabulary are split over the model
    axis)."""
    def share(t) -> float:
        if t.dim() >= 2 and t.shape[-1] == cfg.d_model and not (
                cfg.moe and t.shape[0] == cfg.n_experts):
            return 1.0
        return 1.0 / tp
    return share


# ---------------------------------------------------------------------------
# Collectives (analytic: no partitioned HLO to parse)
# ---------------------------------------------------------------------------


def _tp_allreduces(cfg: ModelConfig, kind: str, seq: int) -> list:
    """``(tokens a sequence, count)`` of the tensor-parallel all-reduces of
    one forward: one after each attention (or mixer) block and one after
    each MLP (or expert) block, a layer."""
    s = 1 if kind == "decode" else seq
    if cfg.family == "rwkv":
        return [(s, 2 * cfg.n_layers)]
    if cfg.family == "hybrid_ssm":
        return [(s, cfg.n_layers + 2 * D.n_invocations(cfg))]
    if cfg.family == "encdec":
        out = [(s, 3 * cfg.n_layers)]        # self, cross, MLP
        if kind != "decode":
            out.append((cfg.encoder_seq, 2 * cfg.encoder_layers))
        return out
    n = 2 * cfg.n_layers
    if cfg.mtp and kind == "train":
        n += 2
    return [(s, n)]


def collective_bytes(cfg: ModelConfig, cell, params, layout,
                     n_local: int, n_micro: int = 1) -> dict:
    """Operand bytes a device of each collective one step runs (the
    reference's convention for ``collective_bytes_from_hlo``), reckoned
    from the sharding rules over ``layout``:

      * all-gather: each parameter leaf split over the batch (FSDP) axes
        is gathered from its shard once a forward; when training, again in
        the backward (under remat, the recomputed forward), a micro-batch
        each;
      * reduce-scatter (train): the gradient of each such leaf, this
        device's model-axis piece before the scatter, a micro-batch each
        (float32 accumulators when ``n_micro`` > 1);
      * all-reduce: the tensor-parallel sums of the attention (or mixer)
        and MLP (or expert) outputs, ``(local batch, S, d)`` in the
        working type, a layer each, twice when training (forward and
        backward); when training, also the gradient of each leaf the batch
        axes replicate, over those axes;
      * all-to-all (moe, mla_moe): each routed layer's dispatch and combine
        of its ``top_k`` token copies over the model axis, twice when
        training.

    A layout with one device on an axis runs none of that axis's
    collectives.
    """
    sizes = pt.axis_sizes_of(layout)
    fsdp_axes = batch_axes(layout)
    fsdp_n = _prod(sizes[a] for a in fsdp_axes)
    tp = sizes.get("model", 1)
    train = cell.kind == "train"
    passes = 2 if train else 1
    out = {k: 0 for k in _COLLECTIVES}
    count = {k: 0 for k in _COLLECTIVES}

    shardings = shd.param_shardings(params, layout)
    grad_item = 4 if n_micro > 1 else None
    for t, s in zip(_leaves(params), pytree.tree_leaves(shardings)):
        parts = pt.spec_parts(s.spec, tuple(t.shape), sizes)
        entries = tuple(s.spec) + (None,) * (t.ndim - len(s.spec))
        split_fsdp = 1
        for n, entry in zip(parts, entries):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            if n > 1 and any(a in fsdp_axes for a in axes):
                split_fsdp *= n
        shard = t.numel() // _prod(parts)
        item = grad_item or t.element_size()
        if split_fsdp > 1:
            out["all-gather"] += passes * n_micro * shard * t.element_size()
            count["all-gather"] += passes * n_micro
            if train:
                out["reduce-scatter"] += n_micro * shard * split_fsdp * item
                count["reduce-scatter"] += n_micro
        elif train and fsdp_n > 1:
            out["all-reduce"] += n_micro * shard * item
            count["all-reduce"] += n_micro

    if tp > 1:
        b = n_local // n_micro
        act = torch.empty((), dtype=cfg.cdt).element_size()
        seq = cell.seq_len
        for tokens, n in _tp_allreduces(cfg, cell.kind, seq):
            out["all-reduce"] += (passes * n_micro * n * b * tokens
                                  * cfg.d_model * act)
            count["all-reduce"] += passes * n_micro * n
        if cfg.moe:
            s = 1 if cell.kind == "decode" else seq
            routed = cfg.n_layers - cfg.first_k_dense
            out["all-to-all"] += (2 * passes * n_micro * routed * b * s
                                  * cfg.top_k * cfg.d_model * act)
            count["all-to-all"] += 2 * passes * n_micro * routed
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = count
    out["source"] = "analytic"
    return out


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, multi_pod: bool,
             tp_override: dict | None = None,
             n_micro_override: int | None = None) -> dict:
    cfg = configs.get_config(arch)
    if tp_override:
        cfg = dataclasses.replace(cfg, **tp_override)
    layout = dict(MULTI_POD_MESH if multi_pod else MESH)
    result = {"arch": arch, "shape": shape,
              "mesh": "x".join(str(s) for s in layout.values()),
              "multi_pod": multi_pod}
    result.update(trace_cell(cfg, SHAPES[shape], layout,
                             n_micro_override=n_micro_override))
    return result


def trace_cell(cfg: ModelConfig, cell, layout: dict,
               n_micro_override: int | None = None) -> dict:
    """The dry run of one step of ``cfg`` at shape ``cell`` on the layout
    ``layout`` (``{axis: size}``): the trace, the per-device memory, the
    costs, the collectives and the roofline (the module docstring)."""
    n_chips = _prod(layout.values())
    tp = layout.get("model", 1)
    t0 = time.time()

    params = T.init_model(0, cfg, "meta")
    result = {
        "n_chips": n_chips,
        "kind": cell.kind,
        "n_params": int(sum(t.numel() for t in _leaves(params))),
    }
    b_loc = local_batch(cell, cfg, layout)
    spec = input_specs(cfg, dataclasses.replace(cell, global_batch=b_loc))
    owned = leaf_shares(params, shd.param_shardings(params, layout), layout)
    shares = {"owned": owned, "activation": activation_share(cfg, tp)}
    mem = {"param_bytes": param_bytes_per_device(params, layout)}
    n_micro = 1
    if cell.kind == "train":
        ocfg = opt_config(cfg)
        opt = adamw.init(params, ocfg)
        opt_owned = leaf_shares(opt, shd.opt_state_shardings(opt, layout),
                                layout)
        mem["opt_bytes"] = _owned_bytes(opt_owned)
        owned = owned + opt_owned
        n_micro = n_micro_override or micro_batches(cfg)
        step = S.make_train_step(cfg, ocfg, n_micro=n_micro)
        result["n_micro"] = n_micro
        inputs = spec
        # the new parameter and state trees: each leaf its old one's share
        costs = hlo_cost.step_costs(
            step, params, opt, spec, owned=owned,
            activation=shares["activation"],
            outputs=lambda out: [(t, share) for t, (_, share) in
                                 zip(_leaves(out[:2]), owned)])
    elif cell.kind == "prefill":
        step = S.make_prefill_step(cfg)
        inputs = [spec["tokens"], spec.get("extra_embeds")]
        costs = hlo_cost.step_costs(step, params, spec["tokens"],
                                    extra_embeds=spec.get("extra_embeds"),
                                    **shares)
    else:  # decode: one new token against a full cache
        full = input_specs(cfg, cell)["cache"]
        mem["cache_bytes"] = _device_bytes(
            full, shd.cache_shardings(full, layout), layout)
        step = S.make_serve_step(cfg)
        inputs = spec["token"]
        costs = hlo_cost.step_costs(step, params, spec["token"],
                                    spec["cache"], cell.seq_len - 1,
                                    **shares)
    mem["input_bytes"] = sum(t.numel() * t.element_size()
                             for t in _leaves(inputs))
    t_trace = time.time() - t0
    mem["step_peak_bytes"] = int(costs["peak_bytes"])
    mem["peak_per_device_gib"] = round(sum(mem.values()) / 2**30, 3)

    model_flops = analytic_model_flops(cfg, cell) / n_chips
    flops = costs["flops"] / tp
    bytes_acc = costs["bytes"] / tp
    kernel_flops = sum(k["flops"] for k in costs["kernels"].values())
    coll = collective_bytes(cfg, cell, params, layout, b_loc, n_micro)
    result.update({
        "local_batch": b_loc,
        "t_trace_s": round(t_trace, 1),
        "mem": mem,
        "cost": {"flops_per_device": flops,
                 "bytes_per_device": bytes_acc,
                 "matrix_flops_per_device": (costs["flops"] - kernel_flops)
                 / tp,
                 "kernels": costs["kernels"],
                 "model_flops_per_device": model_flops,
                 "model_over_trace": model_flops / flops if flops else 0.0},
        "collectives": coll,
        "roofline": roofline_terms(flops, bytes_acc, coll["total"]),
        "ok": True,
    })
    return result


def analytic_model_flops(cfg: ModelConfig, cell) -> float:
    """MODEL_FLOPS: 6*N*D (train, dense) / 6*N_active*D (MoE) / 2*N per
    decoded token; prefill = 2*N*D.  Attention S^2 terms excluded by
    convention (the ratio vs traced FLOPs then *shows* attention+remat
    cost)."""
    n = count_params(cfg)
    if cfg.moe:
        routed_total = count_params(cfg)
        # approximate: embedding+attention always active; experts scaled
        moe_p = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_expert
        n = routed_total - moe_p + int(
            moe_p * (cfg.top_k + cfg.n_shared_experts) / cfg.n_experts)
    d_tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * n * d_tokens
    if cell.kind == "prefill":
        return 2.0 * n * d_tokens
    return 2.0 * n * cell.global_batch  # decode: one token per sequence


def roofline_terms(flops_dev: float, bytes_dev: float, coll_bytes_dev: float):
    """Three roofline terms in seconds (per-device quantities in, so chips
    cancel: T = per-device work / per-card peak), against ``H100``."""
    t_c = flops_dev / H100["flops_bf16"]
    t_m = bytes_dev / H100["hbm_gbs"]
    t_l = coll_bytes_dev / H100["link_gbs"]
    dom = max((t_c, "compute"), (t_m, "memory"), (t_l, "collective"))
    return {
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_l,
        "dominant": dom[1],
        "bound_step_s": max(t_c, t_m, t_l),
    }


# ---------------------------------------------------------------------------
# CLI / orchestration
# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=val (val parsed as python "
                         "literal), e.g. --override kv_quant=True")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args()

    if args.all:
        orchestrate(args)
        return

    import ast
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = ast.literal_eval(v)
    res = run_cell(args.arch, args.shape, args.multi_pod,
                   tp_override=overrides or None,
                   n_micro_override=args.n_micro)
    print(json.dumps(res))
    # Paper-spec'd prints:
    sys.stderr.write(
        f"# {args.arch} x {args.shape} mesh={res['mesh']}: "
        f"peak {res['mem']['peak_per_device_gib']} GiB/device, "
        f"{res['cost']['flops_per_device']:.3e} flops/device, "
        f"coll {res['collectives']['total']/2**20:.1f} MiB/device, "
        f"dominant={res['roofline']['dominant']}\n")


def orchestrate(args):
    done = set()
    try:
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["multi_pod"]))
    except FileNotFoundError:
        pass

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = [(a, s, mp)
            for (a, s, _skip) in configs.cells()
            for mp in meshes
            if (a, s, mp) not in done]
    print(f"{len(todo)} cells to run -> {args.out}")
    for arch, shape, mp in todo:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            if p.returncode == 0:
                rec = json.loads(p.stdout.strip().splitlines()[-1])
            else:
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "ok": False, "error": p.stderr[-2000:]}
        except subprocess.TimeoutExpired:
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "ok": False, "error": f"timeout {args.timeout}s"}
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        status = "OK " if rec.get("ok") else "FAIL"
        print(f"[{status}] {arch:20s} {shape:12s} mp={mp} "
              f"({rec['wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
