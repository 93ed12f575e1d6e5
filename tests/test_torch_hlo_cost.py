"""The port's step cost model (``launch/hlo_cost.py``) against the JAX
package's ``hlo_cost.corrected_costs``, and its parts against hand sums.

* The reduced qwen3-0.6b prefill and decode: the port's ``step_costs``
  over a ``meta`` trace against the reference's trip-count-corrected HLO
  count of the same jitted step (on the CPU; importing the reference's
  ``hlo_cost`` sets no flags).  Each side's attention term is taken off
  first, computed here from the shapes: the reference's ``blockwise_attn``
  multiplies every (query chunk, key) block, the port's kernel counts only
  the pairs its mask keeps.  The rest must agree within 2%.
* The ``flash_attention`` notes of a meta prefill equal the calls of the
  wrapper in the same prefill on the CPU.
* The live-memory peak and the bytes of a three-op function, and the
  kernel notes' FLOPs and bytes, against hand sums.
* ``dryrun.collective_bytes`` on a ``{data: 2, model: 2}`` layout against
  hand sums for a one-layer config; a ``{1, 1}`` layout moves nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_cost as JH
from repro.models import decode as JD
from repro.models import steps as JS
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.configs.shapes import ShapeCell
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import launches
from repro_torch.kernels import rwkv_gla as GLA
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_cost
from repro_torch.models import decode as D
from repro_torch.models import steps as S
from repro_torch.models import transformer as T

B, SEQ = 2, 64


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ref_costs(kind):
    cfg = jconfigs.get_config("qwen3-0.6b").reduced()
    params = jax.eval_shape(
        lambda: JT.init_model(jax.random.PRNGKey(0), cfg))
    if kind == "prefill":
        step = jax.jit(JS.make_prefill_step(cfg))
        lowered = step.lower(params, jax.ShapeDtypeStruct((B, SEQ),
                                                          jnp.int32))
    else:
        cache = {k: jax.ShapeDtypeStruct(s, d)
                 for k, (s, d) in JD.cache_spec(cfg, B, SEQ).items()}
        step = jax.jit(JS.make_serve_step(cfg))
        lowered = step.lower(params, jax.ShapeDtypeStruct((B, 1), jnp.int32),
                             cache, jax.ShapeDtypeStruct((), jnp.int32))
    return JH.corrected_costs(lowered.compile().as_text())


def _port_costs(kind):
    cfg = configs.get_config("qwen3-0.6b").reduced()
    params = T.init_model(0, cfg, "meta")
    if kind == "prefill":
        return hlo_cost.step_costs(S.make_prefill_step(cfg), params,
                                   _meta((B, SEQ), torch.int32))
    cache = {k: _meta(s, d) for k, (s, d) in D.cache_spec(cfg, B, SEQ).items()}
    return hlo_cost.step_costs(S.make_serve_step(cfg), params,
                               _meta((B, 1), torch.int32), cache, SEQ - 1)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_match_reference(kind):
    """Matrix FLOPs of the same step, each side's attention term off.  The
    decode attends its cache with plain products on both sides (no
    kernel), so nothing comes off there."""
    cfg = configs.get_config("qwen3-0.6b").reduced()
    ref = _ref_costs(kind)
    got = _port_costs(kind)
    if kind == "prefill":
        # every (chunk, key) block: S x S scores and S x S x Dv products
        ref_attn = (cfg.n_layers * 2 * B * cfg.n_heads * SEQ * SEQ
                    * 2 * cfg.head_dim)
        pairs = SEQ * (SEQ + 1) // 2          # the causal mask's pairs
        port_attn = (cfg.n_layers * 2 * B * cfg.n_heads * pairs
                     * 2 * cfg.head_dim)
        assert got["kernels"]["flash_attention"] == {
            "launches": cfg.n_layers, "flops": port_attn,
            "bytes": got["kernels"]["flash_attention"]["bytes"]}
    else:
        ref_attn = port_attn = 0
        assert got["kernels"] == {}
    ref_rest = ref["flops"] - ref_attn
    port_rest = got["flops"] - port_attn
    terms = {"reference total": ref["flops"], "reference attention":
             ref_attn, "port total": got["flops"], "port attention":
             port_attn, "reference rest": ref_rest, "port rest": port_rest}
    assert abs(port_rest - ref_rest) <= 0.02 * ref_rest, (
        f"{kind}: the FLOPs outside attention differ by more than 2%: "
        f"{terms}")
    assert got["bytes"] > 0 and got["peak_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base", "zamba2-7b"])
def test_flash_notes_equal_cpu_calls(arch, monkeypatch):
    """A meta prefill notes one ``flash_attention`` launch for each call
    the same prefill makes of the wrapper on the CPU (which runs the
    plain version there and counts no launch)."""
    cfg = configs.get_config(arch).reduced()
    spec = dryrun.input_specs(cfg, ShapeCell("p", "prefill", 48, 2))
    extra = spec.get("extra_embeds")
    meta = hlo_cost.step_costs(S.make_prefill_step(cfg),
                               T.init_model(0, cfg, "meta"), spec["tokens"],
                               extra_embeds=extra)
    calls = []
    wrapper = FA.flash_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return wrapper(*args, **kw)

    monkeypatch.setattr(FA, "flash_attention", counting)
    tokens = torch.randint(0, cfg.vocab, tuple(spec["tokens"].shape),
                           dtype=torch.int32)
    extra_cpu = None if extra is None else torch.zeros(
        tuple(extra.shape), dtype=extra.dtype)
    launches.reset()
    S.make_prefill_step(cfg)(T.init_model(0, cfg, "cpu"), tokens,
                             extra_embeds=extra_cpu)
    assert len(calls) > 0
    assert meta["kernels"]["flash_attention"]["launches"] == len(calls)
    assert launches.counts()["flash_attention"] == 0


def _three(x):
    a = x * 2                  # 4 KiB made
    b = a + 1                  # 4 KiB made: 8 KiB live
    del a                      # 4 KiB live
    return b[:10].clone()      # a view, then 40 B made


def test_peak_and_bytes_hand_sum():
    x = _meta((1024,))
    got = hlo_cost.step_costs(_three, x)
    assert got["peak_bytes"] == 2 * 4096
    # mul and add read 4 KiB and write 4 KiB each; the slice is a view;
    # the clone reads and writes 40 B
    assert got["bytes"] == 2 * (4096 + 4096) + 2 * 40
    assert got["flops"] == 0 and got["kernels"] == {}
    halved = hlo_cost.step_costs(_three, x, activation=lambda t: 0.5)
    assert halved["peak_bytes"] == 4096
    # a matrix product: 2 M N K
    mm = hlo_cost.step_costs(lambda a, b: a @ b, _meta((8, 16)),
                             _meta((16, 4)))
    assert mm["flops"] == 2 * 8 * 16 * 4
    assert mm["bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def _reads_inputs(x, cache):
    a = x.t()                      # a view of an input: nothing made
    layer = cache[0]               # a view of the input cache
    layer[:, 0] = 1.0              # a write into it: nothing made
    return (a * 2).sum() + layer.sum()   # 4 KiB made, then 4 B sums


def test_views_of_inputs_count_nothing():
    """Views of the step's inputs and writes into them are not storages
    the step makes: the peak is the 4 KiB product and its 4 B sum."""
    got = hlo_cost.step_costs(_reads_inputs, _meta((32, 32)),
                              _meta((3, 8, 16, 64)))
    assert got["peak_bytes"] == 4096 + 4


def _toy_step(w, x):
    """An activation with ``w``'s element count but not its storage, a
    gradient of ``w`` made from it and named through ``cost.derived``, an
    update of ``w`` and a reduction of the gradient."""
    act = torch.relu(x)                 # (16, 8): w's 128 elements
    grad = act.t().clone()              # (8, 16), made from an activation
    cost.derived({"w": grad}, {"w": w})
    new_w = w - grad                    # an update of w: w's share
    return new_w, act, grad.amax(dim=1)


def test_shares_by_identity_not_numel():
    """On a {data: 2, model: 2} layout with ``w`` split four ways: the
    activation that collides with ``w``'s element count takes the
    activation rule (0.5), the gradient ``w``'s share from its start
    though it was made from an activation, the update ``w``'s share from
    its operand, and the reduction the share ``outputs`` gives it."""
    w, x = _meta((8, 16)), _meta((16, 8))
    assert w.numel() == x.numel()
    got = hlo_cost.step_costs(_toy_step, w, x, owned=[(w, 0.25)],
                              activation=lambda t: 0.5,
                              outputs=lambda out: [(out[2], 0.125)])
    assert got["peak_bytes"] == 512 * 0.5 + 512 * 0.25 + 512 * 0.25 \
        + 32 * 0.125


@pytest.mark.parametrize("window,q_offset", [(None, 0), (5, 0), (None, 3),
                                             (4, 2)])
def test_flash_note_hand_sum(window, q_offset):
    q, k, v = _meta((6, 9, 16)), _meta((3, 12, 16)), _meta((3, 12, 8))
    got = hlo_cost.step_costs(FA.flash_attention, q, k, v, window=window,
                              q_offset=q_offset)
    mask = FA.visible_mask(9, 12, causal=True, window=window,
                           q_offset=q_offset)
    pairs = int(mask.sum())
    assert cost.flash_pairs(9, 12, True, window, q_offset) == pairs
    row = got["kernels"]["flash_attention"]
    assert row == {"launches": 1, "flops": 2 * 6 * pairs * (16 + 8),
                   "bytes": 4 * (6 * 9 * 16 + 3 * 12 * 16 + 3 * 12 * 8
                                 + 6 * 9 * 8)}
    assert got["flops"] == row["flops"]
    ms, by = cost.model_kernel_bound(
        "flash_attention", (q, k, v), (_meta((6, 9, 8)),),
        {"causal": True, "window": window, "q_offset": q_offset})
    bytes_s = row["bytes"] / cost.HBM_BYTES_PER_S
    ops_s = row["flops"] / cost.PEAK_FLOPS["float32"]
    assert ms == max(bytes_s, ops_s) * 1e3
    assert by == ("bytes" if bytes_s >= ops_s else "operations")


def test_gla_note_hand_sum():
    r, k, w = (_meta((4, 7, 8)) for _ in range(3))
    v, u, st = _meta((4, 7, 16)), _meta((2, 8)), _meta((4, 8, 16))
    launches.reset()
    got = hlo_cost.step_costs(GLA.gla_time_mix, r, k, v, w, u, st)
    row = got["kernels"]["gla_time_mix"]
    assert row == {"launches": 1, "flops": 7 * 4 * 7 * 8 * 16,
                   "bytes": 4 * (3 * 4 * 7 * 8 + 4 * 7 * 16 + 2 * 8
                                 + 2 * 4 * 8 * 16 + 4 * 7 * 16)}
    assert launches.counts()["gla_time_mix"] == 0
    y, out = GLA.gla_time_mix(r, k, v, w, u, st)
    assert (y.shape, out.shape, y.device.type) == ((4, 7, 16), (4, 8, 16),
                                                   "meta")


#: One layer of reduced qwen3 on {data: 2, model: 2}: the seven matrices
#: (wq, wk, wv, wo, wg, wu, wd) split over both axes, float32, so each
#: device holds a quarter: 4096 + 2048 + 2048 + 4096 + 3 x 8192 values.
FSDP_SHARD_BYTES = 4 * (4096 + 2048 + 2048 + 4096 + 3 * 8192)
#: The leaves the data axis replicates, this device's piece: embed (512,
#: 128) split over "model", the norms (128 x 3 and 32 x 2) whole.
REPLICATED_BYTES = 4 * (512 * 128 // 2 + 3 * 128 + 2 * 32)
#: A TP all-reduce of the (2, 16, 128) bf16 activations.
ACT_BYTES = 2 * 16 * 128 * 2


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_collectives_hand_sums(kind):
    cfg = configs.get_config("qwen3-0.6b").reduced(n_layers=1)
    params = T.init_model(0, cfg, "meta")
    cell = ShapeCell("c", kind, 16, 4)
    got = dryrun.collective_bytes(cfg, cell, params,
                                  {"data": 2, "model": 2}, 2)
    if kind == "prefill":
        want = {"all-gather": FSDP_SHARD_BYTES, "reduce-scatter": 0,
                "all-reduce": 2 * ACT_BYTES, "all-to-all": 0}
        counts = {"all-gather": 7, "reduce-scatter": 0, "all-reduce": 2,
                  "all-to-all": 0}
    else:
        want = {"all-gather": 2 * FSDP_SHARD_BYTES,
                "reduce-scatter": 2 * FSDP_SHARD_BYTES,
                "all-reduce": REPLICATED_BYTES + 2 * 2 * ACT_BYTES,
                "all-to-all": 0}
        counts = {"all-gather": 14, "reduce-scatter": 7, "all-reduce": 10,
                  "all-to-all": 0}
    assert {k: got[k] for k in want} == want
    assert {k: got["counts"][k] for k in counts} == counts
    assert got["collective-permute"] == 0
    assert got["total"] == sum(want.values())
    assert got["source"] == "analytic"


def test_collectives_one_device_move_nothing():
    for arch in ("qwen3-0.6b", "qwen2-moe-a2.7b"):
        cfg = configs.get_config(arch).reduced()
        params = T.init_model(0, cfg, "meta")
        for kind in ("train", "prefill", "decode"):
            got = dryrun.collective_bytes(cfg, ShapeCell("c", kind, 16, 4),
                                          params, {"data": 1, "model": 1}, 4)
            assert got["total"] == 0 and not any(got["counts"].values())


def test_moe_all_to_all_hand_sum():
    """Each routed layer's dispatch and combine of top_k token copies."""
    cfg = configs.get_config("qwen2-moe-a2.7b").reduced()
    params = T.init_model(0, cfg, "meta")
    got = dryrun.collective_bytes(cfg, ShapeCell("c", "prefill", 16, 4),
                                  params, {"data": 2, "model": 2}, 2)
    routed = cfg.n_layers - cfg.first_k_dense
    assert got["all-to-all"] == 2 * routed * 2 * 16 * cfg.top_k \
        * cfg.d_model * 2
    assert got["counts"]["all-to-all"] == 2 * routed


def test_meta_kernel_rows_of_a_trace_match_the_prefill():
    """The per-device figures a dry-run cell reports are the trace's over
    the model axis, and its matrix FLOPs leave the kernels out."""
    cfg = configs.get_config("qwen3-0.6b").reduced()
    cell = ShapeCell("c", "prefill", 32, 4)
    one = dryrun.trace_cell(cfg, cell, {"data": 1, "model": 1})
    two = dryrun.trace_cell(cfg, cell, {"data": 1, "model": 2})
    assert two["cost"]["flops_per_device"] == \
        one["cost"]["flops_per_device"] / 2
    k = one["cost"]["kernels"]["flash_attention"]
    assert one["cost"]["matrix_flops_per_device"] == \
        one["cost"]["flops_per_device"] - k["flops"]
    assert one["mem"]["param_bytes"] == sum(
        t.numel() * t.element_size() for t in
        torch.utils._pytree.tree_leaves(T.init_model(0, cfg, "meta")))
    assert np.isclose(one["roofline"]["bound_step_s"], max(
        one["roofline"][t] for t in ("t_compute_s", "t_memory_s",
                                     "t_collective_s")))
