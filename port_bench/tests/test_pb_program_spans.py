"""The readers of the program's own spans and counters (program_spans.py and
its twelve metrics): one synthetic record set, each reader's value on it; None
on an empty recorder, on a run with no traced segment and on a program
without utils/trace.py; and the twelve metrics in a tiny traced run on the CPU."""

import json
import sys
import types

import novic_tpu_torch.utils
import pytest

from conftest import ROOT, tiny_cell
from port_bench import harness

NAMES = ["frames_ms.offline", "tower_wait_ms.offline", "decode_step_ms.offline",
         "decode_steps.offline", "decode_wait_ms.offline", "decode_finish_ms.offline",
         "loader_block_ms.train", "loader_produce_ms.train", "step_call_ms.train",
         "tower_issue_ms.offline", "decode_h2d_ms.offline", "decode_prefill_ms.offline"]
MAIN, PRODUCER = 1, 2


def _rec(name, t0, ms, thread=MAIN, **attrs):
    return {"name": name, "t0": t0, "t1": t0 + ms / 1e3, "id": 0, "parent": None, "seq": 0,
            "thread": thread, "attrs": attrs}


def synthetic():
    """Harness spans of a traced segment from t=10 to t=14, and the program's
    records: two batches and two optimizer steps inside it, and records
    before and across its start that the readers leave out."""
    spans = [{"name": "tower", "phase": "traced", "t0": 10.0, "t1": 10.5},
             {"name": "decode", "phase": "traced", "t0": 10.5, "t1": 12.0},
             {"name": "step", "phase": "traced", "t0": 12.0, "t1": 14.0},
             {"name": "tower", "phase": "window", "t0": 2.0, "t1": 3.0}]
    recs = [_rec("embed.frames", 2.0, 900.0),           # the window: not traced
            _rec("loader.produce", 9.99, 20.0, PRODUCER),  # straddles the segment's start
            _rec("embed", 10.0, 100.0, images=4), _rec("embed.frames", 10.0, 20.0),
            _rec("embed.forward", 10.02, 30.0), _rec("embed.wait", 10.05, 50.0),
            _rec("embed", 10.2, 100.0, images=4), _rec("embed.frames", 10.2, 10.0),
            _rec("embed.forward", 10.21, 30.0), _rec("embed.wait", 10.24, 60.0)]
    for b, t in enumerate((10.5, 11.2)):
        recs += [_rec("decode", t, 600.0, rows=4), _rec("decode.h2d", t, 0.5 + b),
                 _rec("decode.prefill", t + 0.002, 8.0)]
        recs += [_rec("decode.step", t + 0.01 * i, 8.0, step=i + 1) for i in range(7)]
        recs += [_rec("decode.wait", t + 0.1, 1.0), _rec("decode.finish", t + 0.2, 10.0 + 2 * b)]
    recs += [_rec("train.step", 12.0, 300.0), _rec("train.step", 13.0, 200.0)]
    recs += [_rec("loader.wait", 12.5 + 0.01 * i, 1.0) for i in range(8)]
    recs += [_rec("loader.produce", 12.0 + 0.05 * i, 2.0, PRODUCER, index=i) for i in range(16)]
    return spans, recs, {"decode.steps": 14}


EXPECTED = {"frames_ms.offline": 15.0, "tower_wait_ms.offline": 55.0,
            "decode_step_ms.offline": 8.0, "decode_steps.offline": 7.0,
            "decode_wait_ms.offline": 1.0, "decode_finish_ms.offline": 11.0,
            "loader_block_ms.train": 4.0, "loader_produce_ms.train": 16.0,
            "step_call_ms.train": 250.0, "tower_issue_ms.offline": 30.0,
            "decode_h2d_ms.offline": 1.0, "decode_prefill_ms.offline": 8.0}


@pytest.fixture
def recorder(monkeypatch):
    from novic_tpu_torch.utils import trace

    def install(recs, counters):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    return install


def read(name, spans):
    return harness.metric_reader(ROOT, name).read(types.SimpleNamespace(spans=spans), name)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_the_synthetic_records(recorder, name):
    spans, recs, counters = synthetic()
    recorder(recs, counters)
    assert read(name, spans) == pytest.approx(EXPECTED[name], rel=1e-9)


def test_every_new_metric_is_in_the_manifest_with_a_reader():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    assert set(NAMES) <= set(per_layer)
    for name in NAMES:
        assert per_layer[name]["source"] in ("program_span", "program_counter")
        assert harness.metric_reader(ROOT, name) is not None


@pytest.mark.parametrize("name", NAMES)
def test_reader_returns_none_with_nothing_to_read(recorder, monkeypatch, name):
    spans, recs, counters = synthetic()
    recorder([], {})
    assert read(name, spans) is None               # an empty recorder
    recorder(recs, counters)
    assert read(name, [s for s in spans if s["phase"] != "traced"]) is None  # no traced segment
    monkeypatch.delattr(novic_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "novic_tpu_torch.utils.trace", None)
    assert read(name, spans) is None               # a program without utils/trace.py


@pytest.mark.parametrize("workload", ["siglip_b16_ft0.offline_b256_guided",
                                      "eva02_l14_ft0.offline_b64_unguided",
                                      "siglip_b16_ft0.train_cache"])
def test_tiny_traced_run_reports_its_program_metrics(workload):
    from novic_tpu_torch.utils import trace

    trace.clear()
    run = harness.Run(ROOT, tiny_cell(workload), 3_000_000_011, 0.3, True, device="cpu")
    metrics = harness.execute(run)["metrics"]
    trace.clear()
    mine = [m["name"] for m in run.cell.per_layer if m["name"] in NAMES]
    assert len(mine) == (3 if "train" in workload else 9)
    assert all(metrics[n]["value"] > 0 for n in mine), metrics
    if "decode_steps.offline" in mine:
        assert metrics["decode_steps.offline"]["value"] == 7.0
