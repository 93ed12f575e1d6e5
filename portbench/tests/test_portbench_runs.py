"""Whole runs at tiny sizes on the CPU: sound, the control, planted faults.

``harness.run_cell`` skips the look for a card; a planted fault takes the
timed operation's place (``program``) and ``correct`` must come out false.
Besides the cells of ``BENCHMARK.json``, the runs cover the 1-D ``hacc``
configuration and the ``write`` mix, which no cell runs on the card yet
(the port refuses a full-size HACC field), so that the harness, the
judge and the plain decoder stay sound for the cells that will.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import control, harness
ROOT = Path(__file__).resolve().parents[2]

SHAPES = {"hacc": (6000,), "hurricane": (4, 20, 30)}
#: Cells that no chip runs yet, in the form ``BENCHMARK.json`` gives one.
EXTRA = [{"name": "hacc.read_once", "config": "hacc", "traffic": "read_once",
          "chips": 1, "why": "tests only"},
         {"name": "hacc.write", "config": "hacc", "traffic": "write",
          "chips": 1, "why": "tests only"}]
CELLS = ["hacc.read_once", "hurricane.read_once", "hurricane.reread",
         "hacc.write"]


def bench_with_extra() -> dict:
    bench = harness.load_benchmark()
    bench["workloads"] = bench["workloads"] + EXTRA
    return bench


def _run(cell, program=None, trace=False, seed=2**31 + 3):
    config = cell.split(".")[0]
    return harness.run_cell(cell, seed, 0.2, trace, device="cpu",
                            shape=SHAPES[config], program=program,
                            bench=bench_with_extra())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s", "ratio"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_field_is_checked(cell):
    """A fault in one field alone, whichever the seed, reads false."""
    n = harness.load_config(cell.split(".")[0])["fields"]
    for f in (0, n - 1):
        def one_field(codec, op, f=f):
            return _in_one_field(codec, op, f)
        assert not _run(cell, program=one_field)["correct"], f


@pytest.mark.parametrize("cell", ["hurricane.read_once", "hacc.write"])
def test_traced_run_reports_layers(cell):
    r = _run(cell, trace=True)
    assert r["correct"] and "breakdown" in r
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = _run(cell, program=control.control_program)
    assert not r["correct"]
    assert r["checks"]["err_over_bound"]["value"] > 1.0
    assert r["checks"]["lattice_mismatch"]["value"] > 0


def _altered(codec, op):
    """An answer altered where it is produced."""
    if op == "read":
        def read(c):
            out = codec.decompress(c).clone()
            out.view(-1)[out.numel() // 2] += 2 * c.eb
            return out
        return read

    def write(x):
        c = codec.compress(x)
        units = c.stream.units.clone()
        units[units.numel() // 4] ^= 1 << 9
        return dataclasses.replace(
            c, stream=dataclasses.replace(c.stream, units=units))
    return write


def _in_one_field(codec, op, target):
    """``_altered``, but in the outputs of one field only: the field whose
    original or stored form is the ``target``-th met in warm-up."""
    seen, altered = [], _altered(codec, op)
    stock = codec.decompress if op == "read" else codec.compress

    def step(item):
        known = [i for i, s in enumerate(seen) if s is item]
        if not known:
            seen.append(item)
            known = [len(seen) - 1]
        return altered(item) if known[0] == target else stock(item)
    return step


def _unchanged(codec, op):
    """A step that hands back its previous state instead of new work."""
    last = {}

    def step(item):
        out = last.get("out")
        last["out"] = (codec.decompress(item) if op == "read"
                       else codec.compress(item))
        return out if out is not None else last["out"]
    return step


def _half(codec, op):
    """Half of the work left out."""
    if op == "read":
        def read(c):
            out = codec.decompress(c).clone()
            flat = out.view(-1)
            flat[flat.numel() // 2:] = 0
            return out
        return read
    return lambda x: codec.compress(x.reshape(-1)[: x.numel() // 2])


@pytest.mark.parametrize("fault", [_altered, _unchanged, _half])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_caught(cell, fault):
    assert not _run(cell, program=fault)["correct"]


def test_foreign_names_are_whole_names():
    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    sys.modules["repro_torch_probe"] = sys
    try:
        assert "repro" not in run.foreign_modules()
    finally:
        del sys.modules["repro_torch_probe"]


def test_run_imports_no_jax_and_no_jax_package():
    code = (
        "import sys; sys.path[:0] = ['src', '.', 'portbench']\n"
        "import run\n"
        "from portbench import harness\n"
        "harness.run_cell('hurricane.read_once', 1, 0.1, True, device='cpu',"
        " shape=(3, 8, 9))\n"
        "bench = harness.load_benchmark()\n"
        "bench['workloads'].append({'name': 'hacc.write', 'config': 'hacc',"
        " 'traffic': 'write', 'chips': 1, 'why': 'tests only'})\n"
        "harness.run_cell('hacc.write', 1, 0.1, False, device='cpu',"
        " shape=(500,), bench=bench)\n"
        "bad = run.foreign_modules()\n"
        "assert 'repro_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "print('FOREIGN', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT)}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for machines "
                    "without one")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "hurricane.reread", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "hurricane.reread", "--seed", "4", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    import json
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
