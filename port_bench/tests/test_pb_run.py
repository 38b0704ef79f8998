"""A whole run on the CPU at a tiny size, with the card's look skipped: the
result line's schema, the checks that decide `correct`, the control judged
in the program's place, the faults a serving cell can have, and the modules the run loads."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, seeded_decoder_cell, tiny_cell
from port_bench import compare, faults, harness

WL = "siglip_b16_ft0.offline_b256_guided"


def tiny_run(workload=WL, trace=False, seconds=0.5, **mix):
    return harness.Run(ROOT, tiny_cell(workload, **mix), 2_222_222_227, seconds, trace,
                       device="cpu")


def test_result_line_schema():
    result = harness.execute(tiny_run())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"images_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == {"embed_gap", "score_gap", "label_mismatch", "off_guide"}
    json.dumps(result)


def test_traced_result_has_layers_and_breakdown():
    result = harness.execute(tiny_run(trace=True))
    assert {"tower_ms.offline", "decode_ms.offline", "mfu.offline"} <= set(result["metrics"])
    assert "images_per_s" not in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_in_the_programs_place_is_not_correct():
    run = tiny_run()
    run.control = True
    result = harness.execute(run)
    assert result["correct"] is False
    assert set(result["checks"]) == {"embed_gap", "score_gap"}
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert all(c["value"] <= c["limit"] for c in run.program_checks.values())


def test_missed_targets_counts_beyond_a_tie():
    class Decoder:
        def score_all(self, embed):
            return np.array([0.0, -1.0, -2.0, -2.0001, -5.0])

    embeds = torch.zeros(2, 3)
    # -2.0 and -2.0001 tie within 4e-4: either may be returned
    assert compare._missed_targets(Decoder(), embeds, [[0, 1, 2], [0, 1, 3]], 4e-4) == 0
    # the best target left out counts, however the rest rank
    assert compare._missed_targets(Decoder(), embeds, [[1, 2, 3], [0, 1, 2]], 4e-4) == 1


def test_best_target_dropped_returns_ranks_two_to_k_plus_one(monkeypatch):
    import novic_tpu_torch.infer as infer

    def ranked(model, embed, *, topk, **kwargs):
        r = torch.arange(topk)[None, :].repeat(2, 1)
        return r[..., None], r[..., None] < 0, -r.float()

    monkeypatch.setattr(infer, "generate_all", ranked)
    with faults.EXHAUSTIVE["best_target_dropped"]():
        t, p, s = infer.generate_all(None, None, topk=3)
    assert t.shape == (2, 3, 1) and t[0, :, 0].tolist() == [1, 2, 3]
    assert s[1].tolist() == [-1.0, -2.0, -3.0]


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
def test_a_broken_timed_path_is_not_correct(fault):
    with faults.SERVING[fault]():
        result = harness.execute(tiny_run())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("side", ["program", "control", *sorted(faults.SERVING)])
def test_cell_with_a_seeded_decoder(side):
    """SigLIP-L/16-256's tower with a decoder drawn from the seed at 1024:
    correct as the program runs it, not correct with the control in its
    place or with a fault in its timed path."""
    run = harness.Run(ROOT, seeded_decoder_cell(WL), 2_222_222_229, 0.5, False, device="cpu")
    run.control = side == "control"
    with faults.SERVING[side]() if side in faults.SERVING else contextlib.nullcontext():
        result = harness.execute(run)
    assert result["correct"] is (side == "program"), result["checks"]


def test_run_loads_no_jax_and_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from conftest import tiny_cell\nfrom port_bench import harness\n"
            "r = harness.Run(harness.Path(%r), tiny_cell(%r), 5, 0.3, False, device='cpu')\n"
            "assert harness.execute(r)['correct']\nprint(harness.forbidden_modules())\n"
            % (str(ROOT), str(ROOT / "port_bench" / "tests"), str(ROOT), WL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    families = sorted((ROOT / "port_bench" / "reference" / "families").glob("*.py"))
    assert {f.stem for f in families} >= {"siglip", "eva02"}
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.decoder, port_bench.reference.towers\n"
            "from port_bench.harness import load_module\n"
            "for f in %r: load_module(__import__('pathlib').Path(f))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'novic_tpu', 'novic_tpu_torch'}))"
            % (str(ROOT), [str(f) for f in families]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]


def test_command_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "port_bench" / "run.py"), "--workload", WL,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", WL, "--seed", "7",
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
