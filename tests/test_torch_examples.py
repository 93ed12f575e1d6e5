"""``method="naive_ref"`` and the example twins, on the CPU.

* ``naive_ref`` of the port decompresses bit for bit as the reference's
  ``naive_ref`` and as the port's ``gap`` decode, on three field shapes at
  ``max_len`` 12 and 20; it builds no plan, a ``decompress_batch`` is a
  ``decompress`` a tensor, ``fused=True`` with it falls back as in the
  reference (the same reason, one ``fused_fallbacks`` a tensor), and a plan
  for it is refused as the reference's ``build_plan`` refuses it.  (The
  card's ``decode_chunked`` one-chunk decode is held against
  ``decode_sequential`` in ``test_torch_cuda.py``.)
* Each ``examples/*_torch.py`` twin runs with ``--device cpu`` at its
  reference's sizes (``train_e2e_torch`` at fewer steps,
  ``grad_compression_dp_torch`` with 2 ranks) and keeps its reference's
  asserts.  The quickstart's codec numbers (compressed size, ratio, error
  bound, every max error, the batch's dispatches) equal the reference
  compressor's on the same field, computed here; the reference's examples
  are not run (its quickstart decodes in interpret mode).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.api import Codec as JCodec, CodecConfig as JConfig
from repro.core.huffman import pipeline as jhp
from repro.core.sz import compressor as jcompressor
from repro.data.pipeline import smooth_field as jsmooth_field

from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
FIELDS = {"1d": (3000,), "2d": (40, 50), "3d": (8, 10, 12)}


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1)
    return (x + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("max_len", [12, 20])
@pytest.mark.parametrize("shape", list(FIELDS))
def test_naive_ref_matches_reference(shape, max_len):
    x = _field(FIELDS[shape], seed=len(shape) + max_len)
    jcfg = JConfig(max_len=max_len)
    cj = JCodec(jcfg).compress(x)
    want = np.asarray(JCodec(jcfg.replace(method="naive_ref"))
                      .decompress(cj)).tobytes()
    cfg = CodecConfig(max_len=max_len, device="cpu")
    ct = Codec(cfg).compress(torch.from_numpy(x))
    assert np.array_equal(ct.stream.units.numpy(), np.asarray(cj.stream.units))
    naive = Codec(cfg.replace(method="naive_ref"))
    naive.reset_stats()
    got = naive.decompress(ct)
    assert naive.stats["plan_builds"] == 0
    assert got.numpy().tobytes() == want
    assert Codec(cfg).decompress(ct).numpy().tobytes() == want
    codes = hp.decode_naive_ref(ct.stream, ct.codebook, ct.n_symbols)
    gap = Codec(cfg).decode(ct.stream, ct.codebook, ct.n_symbols)
    assert torch.equal(codes.to(torch.int32), gap.to(torch.int32))


def test_naive_ref_fused_falls_back_as_reference():
    x = _field((40, 50), seed=3)
    cj = JCodec(JConfig()).compress(x)
    jcodec = JCodec(JConfig(method="naive_ref", fused=True))
    jcodec.reset_stats()
    want = np.asarray(jcodec.decompress(cj)).tobytes()
    codec = Codec(CodecConfig(method="naive_ref", fused=True, device="cpu"))
    ct = codec.compress(torch.from_numpy(x))
    codec.reset_stats()
    assert codec.decompress(ct).numpy().tobytes() == want
    assert codec.stats["fused_fallbacks"] == \
        jcodec.stats["fused_fallbacks"] == 1
    assert codec.stats["fused_dispatches"] == 0
    assert compressor.fused_unsupported_reason(
        ct, codec.backend, "naive_ref", "tile") == \
        jcompressor.fused_unsupported_reason(cj, "ref", "naive_ref", "tile")


def test_naive_ref_batch_and_plans():
    cfg = CodecConfig(method="naive_ref", device="cpu")
    codec = Codec(cfg)
    cs = [codec.compress(torch.from_numpy(_field(s, seed=i)))
          for i, s in enumerate(FIELDS.values())]
    codec.reset_stats()
    outs = codec.decompress_batch(cs)
    assert codec.stats["plan_builds"] == 0
    assert codec.stats["decode_write_dispatches"] == 0
    gap = Codec(cfg.replace(method="gap"))
    for c, out in zip(cs, outs):
        assert torch.equal(out, gap.decompress(c))
    # a plan is what naive_ref does without, here as in the reference
    with pytest.raises(ValueError, match="unknown method 'naive_ref'"):
        codec.plan_for(cs[0])
    cj = JCodec().compress(_field((64,), 0))
    with pytest.raises(ValueError, match="unknown method 'naive_ref'"):
        jhp.build_plan(cj.stream, cj.codebook, method="naive_ref")
    with pytest.raises(ValueError, match="unknown method 'naive_ref'"):
        compressor.decompress_batch(cs, method="naive_ref", backend="ref")
    assert compressor.decompress(cs[0], method="naive_ref",
                                 backend="ref").shape == cs[0].shape


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_numbers_equal_reference(capsys):
    """Every number the twin prints equals the reference compressor's on
    the same field.  The reference decodes every method and strategy to
    the same bits, so its tuned line and its batch's errors come from its
    per-tensor decode here (its ``decompress_batch``, under its tree
    functions too, compiles a decode a class: ~17 s on the CPU); the
    batch's dispatch count is the port's own."""
    _example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()

    x = jsmooth_field((512, 512), seed=0)
    codec = JCodec()
    c = codec.compress(x)
    want = [f"input: (512, 512) float32, {x.nbytes / 2**20:.1f} MiB",
            f"compressed: {c.compressed_bytes / 2**20:.2f} MiB "
            f"(ratio {c.ratio:.2f}x, eb {c.eb:.3e})"]
    errs = {}
    for method in ("gap", "selfsync", "naive_ref"):
        xh = np.asarray(JCodec(JConfig(method=method)).decompress(c))
        err = errs[method] = np.abs(xh - x).max()
        want.append(f"decompress[{method:10s}]: max err {err:.3e} "
                    f"(bound {c.eb_effective:.3e}) "
                    f"{'OK' if err <= c.eb_effective else 'VIOLATION'}")
    want.append(f"decompress[cuda-tuned]: max err {errs['gap']:.3e}")
    err = max(float(np.abs(np.asarray(codec.decompress(codec.compress(
        jsmooth_field((128, 512), seed=s)))) - jsmooth_field(
            (128, 512), seed=s)).max()) for s in range(4))
    batch = out[6].split(" class dispatches")[0]
    assert batch.startswith("decompress_batch[4 shards]: ")
    assert 1 <= int(batch.rsplit(" ", 1)[1]) <= 4 * (JConfig().t_high + 1)
    want.append(f"{batch} class dispatches, max err {err:.3e}")
    w = jsmooth_field((256, 64), seed=7)
    err = np.abs(np.asarray(codec.decompress(codec.compress(w))) - w).max()
    want.append(f"compress_tree/decompress_tree: max err {err:.3e}, "
                f"step passthrough 3")
    assert out == want
    assert sum(line.endswith("OK") for line in out) == 3


def test_kv_offload_paging_torch(capsys):
    _example("kv_offload_paging_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "paged 2 blocks out / 2 in" in out
    assert out.rstrip().endswith("OK")


def test_long_context_serve_torch(capsys):
    _example("long_context_serve_torch").main(["--device", "cpu"])
    assert "generated token matrix: (2, 33) OK" in capsys.readouterr().out


def test_train_e2e_torch(tmp_path, capsys):
    _example("train_e2e_torch").main(["--device", "cpu", "--steps", "20",
                                      "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert out.rstrip().endswith(": OK")


def test_compressed_checkpoint_torch(capsys):
    _example("compressed_checkpoint_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "restore within error bound: OK" in out
    assert "continued training" in out and out.rstrip().endswith("OK")


def test_grad_compression_dp_torch_two_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                        if env.get("PYTHONPATH") else []))
    p = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES,
                                      "grad_compression_dp_torch.py"),
         "--device", "cpu", "--ranks", "2", "--steps", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert lines[0].startswith("exact_f32   : loss ")
    assert lines[1].startswith("compressed  : loss ")
    assert "(2.67x less traffic)" in lines[2]
    assert lines[3].startswith("grad tree via encode_backend='cuda': "
                               f"{8 * 2 * 512 * 4} B -> ")
    assert lines[3].endswith("1 encode dispatches, 0 fallbacks)")


def test_examples_import_only_the_port():
    """The twins import ``repro_torch`` and nothing of the JAX package."""
    for name in sorted(os.listdir(EXAMPLES)):
        if not name.endswith("_torch.py"):
            continue
        src = open(os.path.join(EXAMPLES, name)).read()
        assert "repro_torch" in src, name
        for bad in ("import jax", "from jax", "from repro.", "import repro\n",
                    "from repro import"):
            assert bad not in src, (name, bad)
    assert len([n for n in os.listdir(EXAMPLES)
                if n.endswith("_torch.py")]) == 6
