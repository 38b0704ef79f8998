"""Readings from which the limits of a cell's comparison are set: the
program's numbers on many seeds, and the lower-precision control's on some.

    python3 port_bench/control.py --workload <name> --seconds 5 \
        --seeds 101,102,...  --control-seeds 101,102,103

Each seed runs the cell as run.py does (set-up from the seed, a window of
`--seconds` at the cell's own load, the comparison at the timed sizes), in
one process, one after another; a seed in --control-seeds also reads the
control on the same sampled rows (compare.control: the tower at the next
lower precision, the decoder's products in TF32) and judges it, in the
program's place, by the cell's limits, as `run.py --control 1` does. One
JSON line a seed: the program's readings, the control's and the verdict on
the side judged; the last line the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness
    from port_bench.run import cache_environment

    cache_environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(ROOT, cell, seed, args.seconds, False)
        run.control = seed in controls
        result = harness.execute(run)
        program = run.program_checks if run.control else result["checks"]
        control = result["checks"] if run.control else {}
        for name, c in program.items():
            lower[name] = max(lower.get(name, 0.0), c["value"])
        for name, c in control.items():
            upper[name] = min(upper.get(name, float("inf")), c["value"])
        print(json.dumps({"seed": seed, "judged": "control" if run.control else "program",
                          "correct": result["correct"],
                          "program": {k: c["value"] for k, c in program.items()},
                          "control": {k: c["value"] for k, c in control.items()},
                          "metrics": result["metrics"]}), flush=True)
        harness.free_device()
    print(json.dumps({"workload": args.workload, "program_max": lower, "control_min": upper,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
