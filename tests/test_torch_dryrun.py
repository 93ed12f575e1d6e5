"""The port's dry run (``launch/dryrun.py``) against the JAX package's.

* For each of the 33 cells of ``configs.cells()``: ``input_specs``
  (shapes and dtypes), ``analytic_model_flops``, ``opt_config``,
  ``micro_batches`` and ``count_params`` equal the reference's exactly;
  ``roofline_terms`` equal under one shared constants table.
* The per-device parameter bytes of every arch on the ``{16, 16}``
  layout equal the reference's: ``jax.eval_shape(init_model)``,
  ``param_shardings`` on ``make_production_mesh()`` and ``shard_shape``
  there; ``init_model(..., "meta")`` and the sharding rules here.
* The reference's ``dryrun`` sets ``XLA_FLAGS`` to 512 host devices when
  imported, which would reach every later test of a worker, so it is
  imported only in one subprocess that computes all of its side and
  prints it as JSON.
* Meta cases: ``init_model(..., "meta")`` gives the CPU init's shapes and
  dtypes leaf by leaf on reduced configs and draws nothing; ``run_cell``
  on a reduced config at small shape cells is ``ok`` for prefill, decode
  and train of each family; a ``meta`` tensor on a codec kernel wrapper
  raises.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch import configs
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from repro_torch.models.config import count_params

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
CELLS = [(a, s) for a, s, _ in configs.cells()]
#: (flops, bytes, collective bytes) a device, for the roofline terms.
ROOF_CASES = ((1e15, 1e9, 1e6), (1e9, 4e12, 1e6), (1e9, 1e9, 1e12))
#: The shared constants table both roofline_terms run under.
ROOF_TABLE = {"flops_bf16": 1e15, "hbm_gbs": 2e12, "link_gbs": 1e11}

_REFERENCE = r"""
import json
import sys
from repro.launch import dryrun as R   # sets XLA_FLAGS: 512 host devices
import jax
from repro import configs
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as JT
from repro.models.config import count_params
from repro.runtime import sharding as shd


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = [list(v.shape), str(v.dtype)]
    return out


cells = {}
for arch, shape, _ in configs.cells():
    cfg = configs.get_config(arch)
    cell = configs.SHAPES[shape]
    cells[arch + "/" + shape] = {
        "specs": flat(R.input_specs(cfg, cell)),
        "model_flops": R.analytic_model_flops(cfg, cell),
        "state_dtype": R.opt_config(cfg).state_dtype,
        "n_micro": R.micro_batches(cfg),
        "count_params": count_params(cfg)}
mesh = make_production_mesh()
param_bytes = {}
for arch in configs.REGISTRY:
    cfg = configs.get_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), cfg))
    n = 0
    for x, s in zip(jax.tree.leaves(shapes),
                    jax.tree.leaves(shd.param_shardings(shapes, mesh))):
        k = 1
        for d in s.shard_shape(x.shape):
            k *= d
        n += k * x.dtype.itemsize
    param_bytes[arch] = n
table = json.loads(sys.argv[1])
R.V5E.update(flops_bf16=table["flops_bf16"], hbm_gbs=table["hbm_gbs"],
             ici_link_gbs=table["link_gbs"])
roof = [R.roofline_terms(*c) for c in json.loads(sys.argv[2])]
print(json.dumps({"cells": cells, "param_bytes": param_bytes,
                  "roofline": roof}))
"""


@pytest.fixture(scope="module")
def ref():
    """Everything of the reference's side, from one subprocess."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _REFERENCE,
                        json.dumps(ROOF_TABLE), json.dumps(ROOF_CASES)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = [list(v.shape),
                               str(v.dtype).replace("torch.", "")]
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_reference(ref, arch, shape):
    want = ref["cells"][f"{arch}/{shape}"]
    cfg = configs.get_config(arch)
    cell = configs.SHAPES[shape]
    specs = dryrun.input_specs(cfg, cell)
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(specs))
    assert _flat(specs) == want["specs"]
    assert dryrun.analytic_model_flops(cfg, cell) == want["model_flops"]
    assert dryrun.opt_config(cfg).state_dtype == want["state_dtype"]
    assert dryrun.micro_batches(cfg) == want["n_micro"]
    assert count_params(cfg) == want["count_params"]


def test_cells_count():
    """33 cells: 10 archs x 4 shapes less the 7 long_500k cells of
    full-attention archs; both meshes make 66."""
    assert len(CELLS) == 33
    assert len(configs.cells(include_skipped=True)) == 40


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_bytes_per_device(ref, arch):
    params = T.init_model(0, configs.get_config(arch), "meta")
    assert dryrun.param_bytes_per_device(params, dryrun.MESH) == \
        ref["param_bytes"][arch]


def test_roofline_terms_shared_table(ref, monkeypatch):
    # the card's own table: the H100's published peaks
    assert dryrun.H100 == {"flops_bf16": 989e12, "hbm_gbs": 3.35e12,
                           "link_gbs": 450e9}
    monkeypatch.setattr(dryrun, "H100", dict(ROOF_TABLE))
    got = [dryrun.roofline_terms(*c) for c in ROOF_CASES]
    assert got == ref["roofline"]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_init_matches_cpu(arch):
    cfg = configs.get_config(arch).reduced()
    meta = T.init_model(0, cfg, "meta")
    cpu = T.init_model(0, cfg, "cpu")
    pm, tm = pytree.tree_flatten_with_path(meta)
    pc, tc = pytree.tree_flatten_with_path(cpu)
    assert tm == tc
    for (km, m), (kc, c) in zip(pm, pc):
        assert km == kc
        assert m.device.type == "meta" and c.device.type == "cpu"
        assert (m.shape, m.dtype) == (c.shape, c.dtype), km


def test_meta_init_draws_nothing():
    """A full-width meta init allocates nothing and leaves the CPU
    generator where it was."""
    state = torch.random.get_rng_state()
    params = T.init_model(0, configs.get_config("deepseek-v3-671b"), "meta")
    assert torch.equal(state, torch.random.get_rng_state())
    leaves = pytree.tree_leaves(params)
    assert {t.device.type for t in leaves} == {"meta"}
    assert sum(t.numel() for t in leaves) == 671_995_310_080


#: Small shape cells for the reduced configs' dry runs (vlm's text is the
#: sequence less its 256 patches).
SMALL = {"train_4k": ShapeCell("train_4k", "train", 320, 32),
         "prefill_32k": ShapeCell("prefill_32k", "prefill", 320, 32),
         "decode_32k": ShapeCell("decode_32k", "decode", 320, 32)}
#: One arch a family.
FAMILY_ARCHS = {"dense": "qwen3-0.6b", "vlm": "qwen2-vl-72b",
                "moe": "qwen2-moe-a2.7b", "mla_moe": "deepseek-v3-671b",
                "hybrid_ssm": "zamba2-7b", "encdec": "whisper-base",
                "rwkv": "rwkv6-3b"}
#: The kernel a family's prefill and train steps launch.
FAMILY_KERNEL = {"rwkv": "gla_time_mix"}


def _reduced_overrides(arch):
    cfg = configs.get_config(arch)
    small = cfg.reduced()
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(cfg)
            if getattr(small, f.name) != getattr(cfg, f.name)}


@pytest.mark.parametrize("shape", list(SMALL))
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_run_cell_reduced(monkeypatch, family, shape):
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    arch = FAMILY_ARCHS[family]
    multi_pod = shape == "decode_32k"
    rec = dryrun.run_cell(arch, shape, multi_pod,
                          tp_override=_reduced_overrides(arch))
    json.dumps(rec)
    assert rec["ok"] and rec["kind"] == SMALL[shape].kind
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["local_batch"] == 32 // (32 if multi_pod else 16)
    assert rec["collectives"]["source"] == "analytic"
    assert rec["collectives"]["total"] > 0
    cost = rec["cost"]
    assert cost["flops_per_device"] > 0 and cost["bytes_per_device"] > 0
    assert rec["mem"]["step_peak_bytes"] > 0 and rec["mem"]["param_bytes"] > 0
    kernel = FAMILY_KERNEL.get(family, "flash_attention")
    if SMALL[shape].kind != "decode":
        assert cost["kernels"][kernel]["launches"] > 0
        assert cost["matrix_flops_per_device"] < cost["flops_per_device"]
    roof = rec["roofline"]
    assert roof["bound_step_s"] == max(roof["t_compute_s"],
                                       roof["t_memory_s"],
                                       roof["t_collective_s"])
    if SMALL[shape].kind == "train":
        assert rec["n_micro"] == 1 and rec["mem"]["opt_bytes"] > 0


def _codec_wrappers():
    """Each codec kernel wrapper with CPU arguments from a small payload."""
    from repro_torch.core.codec import Codec, CodecConfig
    from repro_torch.core.huffman import pipeline as hp
    from repro_torch.kernels import huffman_chunked as HC
    from repro_torch.kernels import huffman_decode as K

    x = torch.from_numpy(np.cumsum(np.random.default_rng(0)
                                   .standard_normal(3000)).astype(np.float32))
    c = Codec(CodecConfig(device="cpu")).compress(x)
    plan = hp.build_plan(c.stream, c.codebook, backend="ref")
    luts = hp._as_luts(c.codebook, "cpu")
    stream = (c.stream.units, plan.start_bits, plan.end_bits,
              c.stream.total_bits, luts.dec_sym, luts.dec_len, luts.max_len)
    return {
        "count_subseq": (K.count_subseq, stream),
        "decode_padded": (K.decode_padded, stream),
        "decode_chunked": (HC.decode_chunked, (
            c.stream.units.reshape(1, -1),
            torch.tensor([c.stream.total_bits]),
            torch.tensor([c.n_symbols], dtype=torch.int32), luts.dec_sym,
            luts.dec_len, luts.max_len, c.n_symbols)),
    }


@pytest.mark.parametrize("name", ["count_subseq", "decode_padded",
                                  "decode_chunked"])
def test_codec_wrapper_refuses_meta(name):
    fn, args = _codec_wrappers()[name]
    fn(*args)                                   # the CPU runs
    on_meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                    for a in args)
    with pytest.raises(ValueError, match="device meta"):
        fn(*on_meta)


def test_decode_peak_leaves_the_cache_out():
    """The decode reads a slice of the input cache a layer and writes into
    it: neither is a storage the step makes, so the step's peak (one
    layer's float32 copies, the logits) does not grow with the cache's
    layers while the cache does."""
    cell = ShapeCell("d", "decode", 1024, 2)
    mem = {}
    for n in (2, 6):
        cfg = configs.get_config("qwen3-0.6b").reduced(n_layers=n)
        mem[n] = dryrun.trace_cell(cfg, cell, {"data": 1, "model": 1})["mem"]
    assert mem[6]["cache_bytes"] == 3 * mem[2]["cache_bytes"]
    assert mem[6]["step_peak_bytes"] == mem[2]["step_peak_bytes"]
    assert mem[6]["step_peak_bytes"] < mem[6]["cache_bytes"]


def test_shares_on_a_2x2_layout():
    """On ``{data: 2, model: 2}``: each leaf's share is its shard's (a
    matrix split over both axes a quarter, a norm whole), the residual
    stream is whole on each device, head-split activations and the routed
    families' per-expert buffers half."""
    layout = {"data": 2, "model": 2}
    cfg = configs.get_config("qwen3-0.6b").reduced(n_layers=1)
    params = T.init_model(0, cfg, "meta")
    from repro_torch.runtime import sharding as shd
    shares = dryrun.leaf_shares(params, shd.param_shardings(params, layout),
                                layout)
    by_shape = {tuple(t.shape): f for t, f in shares}
    assert by_shape[(cfg.d_model, cfg.n_heads, cfg.head_dim)] == 0.25
    assert by_shape[(cfg.d_model,)] == 1.0
    act = dryrun.activation_share(cfg, 2)
    meta = lambda *s: torch.empty(s, device="meta")   # noqa: E731
    assert act(meta(2, 16, cfg.d_model)) == 1.0
    assert act(meta(32, cfg.d_model)) == 1.0
    assert act(meta(2, 16, cfg.n_heads, cfg.head_dim)) == 0.5
    assert act(meta(cfg.d_model)) == 0.5
    moe = configs.get_config("qwen2-moe-a2.7b").reduced()
    act = dryrun.activation_share(moe, 2)
    assert act(meta(moe.n_experts, 6, moe.d_model)) == 0.5
    assert act(meta(2, moe.n_experts, moe.d_model)) == 1.0
