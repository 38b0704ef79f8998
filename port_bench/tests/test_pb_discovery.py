"""The harness finds a cell's parts by name: a new config, mix, driver,
limits, per-layer metric, tower family or seeded decoder dropped in as
files, with entries added to BENCHMARK.json, need no edit of an existing
file."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SIGLIP_L
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
    (checkout / "port_bench" / "reference" / "families" / "eva02.py").unlink()
    with pytest.raises(harness.CellError):
        harness.load_cell(checkout, "eva02_l14_ft0.offline_b64_unguided")


# Run from the temporary checkout, as run.py is: its port_bench (bounds
# finds the families beside itself), the program from the repository
NEW_FAMILY_PROBE = """
import json, sys
sys.path.insert(0, {tests!r})
from conftest import SIGLIP_L, tiny_cell
sys.path.insert(0, {checkout!r})
sys.path.insert(1, {root!r})
from pathlib import Path
import torch
from port_bench import bounds, harness

root = Path({checkout!r})
wl = {workload!r}
cell = harness.load_cell(root, wl)
tiny = tiny_cell(wl, root=root)
twin = harness.Cell(**dict(vars(tiny), config=json.loads(json.dumps(tiny.config))))
twin.config["tower"]["family"] = "siglip"
runs = [harness.Run(root, c, 4_100_000_003, 0.5, False, device="cpu") for c in (tiny, twin)]
w = [harness.tower_weights(r) for r in runs]
frames = runs[0].frames(3, tiny.config["tower"]["image_size"])
e = [harness.reference_embeddings(r, frames) for r in runs]
full, full_twin = cell.config["tower"], dict(cell.config["tower"], family="siglip")
out = {{"harness": harness.__file__, "bounds": bounds.__file__,
       "weights": list(w[0]) == list(w[1]) and all(torch.equal(w[0][k], w[1][k]) for k in w[0]),
       "flops": [bounds.tower_flops(full), bounds.tower_flops(full_twin)],
       "tokens": [bounds.tower_tokens(full), bounds.tower_tokens(full_twin)],
       "embeddings": torch.equal(e[0], e[1]),
       "correct": harness.execute(harness.Run(root, tiny, 4_100_000_005, 0.5, False,
                                              device="cpu"))["correct"]}}
print(json.dumps(out))
"""


def test_new_family_and_seeded_decoder_as_files(checkout):
    """A copy of siglip.py as a new family, on SigLIP-L/16-256's tower with a
    decoder drawn from the seed at 1024: new files and entries only."""
    before = {p: p.read_bytes() for p in (checkout / "port_bench").rglob("*") if p.is_file()}
    base = checkout / "port_bench"
    shutil.copy(base / "reference" / "families" / "siglip.py",
                base / "reference" / "families" / "siglip_copy.py")
    cfg = json.loads((base / "configs" / "siglip_b16_ft0.json").read_text())
    cfg["name"] = "siglip_l16_copy_seed"
    cfg["tower"].update(SIGLIP_L, family="siglip_copy", image_size=256, layers=24)
    cfg["decoder"].update(weights="seed", embed_dim=SIGLIP_L["embed_dim"])
    (base / "configs" / "siglip_l16_copy_seed.json").write_text(json.dumps(cfg))
    wl = "siglip_l16_copy_seed.offline_b256_guided"
    shutil.copy(base / "limits" / "siglip_b16_ft0.offline_b256_guided.json",
                base / "limits" / f"{wl}.json")
    manifest = json.loads((checkout / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                "file": "port_bench/configs/siglip_l16_copy_seed.json",
                                "reduced": [], "why": "a new family and a seeded decoder"})
    manifest["workloads"].append({"name": wl, "config": cfg["name"],
                                  "traffic": "offline_b256_guided", "chips": 1, "why": "probe"})
    next(m for m in manifest["end_to_end"] if m["name"] == "images_per_s")["workloads"].append(wl)
    (checkout / "BENCHMARK.json").write_text(json.dumps(manifest))
    (checkout / "assets").mkdir()
    (checkout / cfg["decoder"]["checkpoint"]).symlink_to(ROOT / cfg["decoder"]["checkpoint"])

    code = NEW_FAMILY_PROBE.format(tests=str(ROOT / "port_bench" / "tests"),
                                   checkout=str(checkout), root=str(ROOT), workload=wl)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=checkout)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["harness"].startswith(str(checkout)) and got["bounds"].startswith(str(checkout))
    assert got["weights"] and got["embeddings"]
    assert got["flops"][0] == got["flops"][1] and got["tokens"] == [256, 256]
    assert got["correct"] is True
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
