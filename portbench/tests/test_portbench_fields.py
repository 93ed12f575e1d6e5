"""The surrogate fields and the traffic: one seed, one set of inputs."""

import torch

from portbench import fields, harness, traffic

BIG = 2**31 + 12345


def test_field_repeats_per_seed():
    a = fields.make((4, 5, 6), 0.01, BIG, 2, "cpu")
    b = fields.make((4, 5, 6), 0.01, BIG, 2, "cpu")
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_field_differs_across_seeds_and_fields():
    a = fields.make((1000,), 0.1, BIG, 0, "cpu")
    assert not torch.equal(a, fields.make((1000,), 0.1, BIG + 1, 0, "cpu"))
    assert not torch.equal(a, fields.make((1000,), 0.1, BIG, 1, "cpu"))


def test_field_spans_minus_one_to_one():
    base = fields.make((64, 64), 0.0, 7, 0, "cpu")
    assert float(base.min()) == -1.0 and abs(float(base.max()) - 1.0) < 1e-6


def test_traffic_same_work_other_order():
    a, b = traffic.order(13, BIG), traffic.order(13, BIG + 1)
    assert sorted(a) == sorted(b) == list(range(13))
    assert a == traffic.order(13, BIG) and a != b


def test_every_mix_loads():
    names = {p.stem for p in traffic.MIXES.iterdir()}
    names |= {c["traffic"] for c in harness.load_benchmark()["workloads"]}
    for name in names:
        assert traffic.load(name)["op"] in traffic.OPS
