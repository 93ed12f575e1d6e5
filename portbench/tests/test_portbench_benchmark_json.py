"""BENCHMARK.json against its contract, and every name found as a file."""

import json
import re

from portbench import harness, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {"decompress_GBps", "read_p95_ms", "ratio", "setup_s"}
LAYER = {"plan_builds_per_read", "plan_ms", "decode_ms",
         "decompress_roofline_pct", "device_idle_pct.read"}


def _bench():
    return harness.load_benchmark()


def test_top_level_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_cells_in_order_on_one_chip():
    names = [c["name"] for c in _bench()["workloads"]]
    assert names == ["hurricane.read_once", "hurricane.reread"]
    for c in _bench()["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1 and 1 <= len(c["why"]) <= 200


def test_every_name_is_found():
    b = _bench()
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert "noise_amp" in cfg["assumed"] and cfg["table_iv"]["ratio"] > 1
    for cell in b["workloads"]:
        assert cell["config"] in configs
        traffic.load(cell["traffic"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_file_of_a_name_loads():
    """Configurations and metric readers that no cell names yet load too."""
    for path in sorted((harness.HERE / "configs").glob("*.json")):
        cfg = harness.load_config(path.stem)
        assert cfg["name"] == path.stem and cfg["reduced"] == []
        assert cfg["shape"] == cfg["published"].get(
            "shape", [cfg["published"].get("values_per_field")])
    for path in sorted((harness.HERE / "metrics").glob("[!_]*.py")):
        assert callable(harness.reader(path.stem))


def test_names_units_and_metric_sets():
    b = _bench()
    assert {m["name"] for m in b["end_to_end"]} == E2E
    assert {m["name"] for m in b["per_layer"]} == LAYER
    everything = b["configs"] + b["workloads"] + b["end_to_end"] \
        + b["per_layer"]
    assert all(NAME.match(x["name"]) for x in everything)
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_its_layers_move():
    b = _bench()
    for cell in b["workloads"]:
        e2e = {m["name"] for m in harness.metric_entries(b, cell["name"],
                                                         False)}
        layer = harness.metric_entries(b, cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (cell["name"], m["name"])
