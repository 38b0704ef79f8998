"""BENCHMARK.json against the benchmark's contract, and the files each of its
entries names."""

import json
import re

import pytest

from conftest import ROOT

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["port_bench"] and B["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", B["configs"] + B["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_short_fields(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in B["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
    assert set(m) <= allowed and {"name", "unit", "better", "source"} <= set(m)


def test_unique_names():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def e2e_of(workload):
    return {m["name"] for m in B["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_setup_another_metric_and_a_layer(w):
    e2e = e2e_of(w["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]]) for m in B["per_layer"])
    assert w["chips"] == 1


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    assert m["moves"] in {e["name"] for e in B["end_to_end"]}
    for w in m["workloads"]:
        assert w in {x["name"] for x in B["workloads"]}
        assert m["moves"] in e2e_of(w)


def test_one_layer_name_per_layer_metric_family():
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(w):
    base = ROOT / "port_bench"
    mix = json.loads((base / "mixes" / f"{w['traffic']}.json").read_text())
    assert (base / "drivers" / f"{mix['driver']}.py").is_file()
    assert (base / "limits" / f"{w['name']}.json").is_file()
    assert w["config"] in {c["name"] for c in B["configs"]}


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("port_bench/configs/")
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    assert cfg["source"] == c["source"]


def test_every_per_layer_metric_has_a_reader():
    from port_bench.harness import metric_reader

    for m in B["per_layer"]:
        assert metric_reader(ROOT, m["name"]) is not None, m["name"]
