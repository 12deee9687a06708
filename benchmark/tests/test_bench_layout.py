"""BENCHMARK.json against the contract it is built to, and every name in
it found as a file."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"}),
                       ("end_to_end", {"name", "unit", "better", "bound",
                                       "source", "workloads"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves", "workloads"})):
        for item in SPEC[kind]:
            assert set(item) <= keys, item
            assert NAME.match(item["name"]), item["name"]
            assert (kind, item["name"]) not in seen
            seen.add((kind, item["name"]))
            if "unit" in item:
                assert UNIT.match(item["unit"])
                assert item["better"] in ("lower", "higher")


def test_configs_found_and_whole():
    for c in SPEC["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == []         # a codec has no depth or width
        assert (harness.BENCH / "codecs" / f"{cfg['codec']}.py").is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    cell = harness.Cell.load(workload)
    assert cell.workload["chips"] == 1
    assert harness.load_module("loops", cell.traffic["kind"]).run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_readers_found():
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
