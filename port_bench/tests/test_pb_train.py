"""The training cell on the CPU at a tiny size (32 rows a microbatch, 2 a
step): the reference follows the program's first steps, its control does
not, and the faults a training cell can have make `correct` false."""

import pytest

from conftest import ROOT, tiny_cell
from port_bench import faults, harness

WL = "siglip_b16_ft0.train_cache"


def tiny_run(trace=False):
    return harness.Run(ROOT, tiny_cell(WL), 3_141_592_653, 1.0, trace, device="cpu")


def test_training_run_is_correct_and_control_is_not():
    run = tiny_run()
    run.control = True
    result = harness.execute(run)
    checks = run.program_checks
    assert all(c["value"] <= c["limit"] for c in checks.values())
    assert set(result["metrics"]) == {"samples_per_s", "setup_s"}
    assert set(checks) == {"loss_gap", "grad_gap", "delta_gap", "loader_mismatch"}
    assert checks["loader_mismatch"]["value"] == 0
    # the control, judged in the program's place by the same limits
    assert result["correct"] is False
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "delta_gap"}


def test_traced_training_run_reads_its_layers():
    result = harness.execute(tiny_run(trace=True))
    assert {"loader_wait_ms.train", "mfu.train"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_a_broken_training_step_is_not_correct(fault):
    with faults.TRAINING[fault]():
        result = harness.execute(tiny_run())
    assert result["correct"] is False
