"""The harness finds a cell's parts by name: a new config, mix, driver,
limits and per-layer metric dropped in as files, with entries added to
BENCHMARK.json, need no edit of an existing file."""

import json
import shutil

import pytest

from conftest import ROOT
from port_bench import harness


@pytest.fixture
def checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_new_cell_as_files(checkout):
    before = {p: p.read_bytes() for p in (checkout / "port_bench").rglob("*") if p.is_file()}
    base = checkout / "port_bench"
    cfg = json.loads((base / "configs" / "siglip_b16_ft0.json").read_text())
    cfg["name"] = "siglip_b16_int8_ft0"
    (base / "configs" / "siglip_b16_int8_ft0.json").write_text(json.dumps(cfg))
    (base / "mixes" / "offline_b64_probe.json").write_text(json.dumps(
        {"driver": "probe", "batch": 64, "gencfg": "beam_k10_vnone_gp_t1_a0"}))
    (base / "drivers" / "probe.py").write_text("NAME = 'probe'\n")
    (base / "metrics" / "probe_ms.py").write_text("def read(run, name):\n    return 1.5\n")
    wl = "siglip_b16_int8_ft0.offline_b64_probe"
    (base / "limits" / f"{wl}.json").write_text(json.dumps({"embed_gap": 1e-3}))
    manifest = json.loads((checkout / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "siglip_b16_int8_ft0", "source": cfg["source"],
                                "file": "port_bench/configs/siglip_b16_int8_ft0.json",
                                "reduced": [], "why": "probe"})
    manifest["workloads"].append({"name": wl, "config": "siglip_b16_int8_ft0",
                                  "traffic": "offline_b64_probe", "chips": 1, "why": "probe"})
    next(m for m in manifest["end_to_end"] if m["name"] == "images_per_s")["workloads"].append(wl)
    manifest["per_layer"].append({"name": "probe_ms.offline", "unit": "ms", "better": "lower",
                                  "source": "host_clock", "layer": "decode",
                                  "moves": "images_per_s", "workloads": [wl]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.load_cell(checkout, wl)
    assert cell.config["name"] == "siglip_b16_int8_ft0" and cell.mix["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["probe_ms.offline"]
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s", "setup_s"}
    driver = harness.load_module(base / "drivers" / f"{cell.mix['driver']}.py")
    assert driver.NAME == "probe"
    assert harness.metric_reader(checkout, "probe_ms.offline").read(None, "probe_ms.offline") == 1.5
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_metric_reader_by_full_name_then_stem(checkout):
    metrics = checkout / "port_bench" / "metrics"
    (metrics / "tower_ms.special.py").write_text("def read(run, name):\n    return 7.0\n")
    assert harness.metric_reader(checkout, "tower_ms.special").read(None, "") == 7.0
    assert harness.metric_reader(checkout, "tower_ms.all").__name__.endswith("tower_ms")
    assert harness.metric_reader(checkout, "no_such_metric.offline") is None


def test_missing_parts_are_cell_errors(checkout):
    with pytest.raises(harness.CellError):
        harness.load_cell(checkout, "no_such.cell")
    (checkout / "port_bench" / "limits" / "siglip_b16_ft0.offline_b256_guided.json").unlink()
    with pytest.raises(harness.CellError):
        harness.load_cell(checkout, "siglip_b16_ft0.offline_b256_guided")
