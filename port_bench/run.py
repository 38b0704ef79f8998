"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (novic_tpu_torch) and
BENCHMARK.json. It needs a CUDA card: without one, or with fewer cards than
the cell asks for, it exits 2 and prints no result. The last line of
standard output is the result's JSON; the numbers compared with the plain
reference, each beside its limit, are the last lines of standard error and
the result's last key. It exits 3, printing no result, when the process
holds jax, jaxlib, flax or novic_tpu once the window has closed.

With `--control 1` the comparison judges the lower-precision control
(compare.control) in the program's place, by the same limits: such a run
has to come out with `correct` false.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_environment(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout; no
    library of the run loads JAX through transformers."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the lower-precision control in the program's place")
    args = ap.parse_args(argv)
    cache_environment(ROOT)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except harness.CellError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = harness.Run(ROOT, cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    run.control = bool(args.control)
    try:
        result = harness.execute(run)
    except harness.CellError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: the process holds {', '.join(found)} after the window", file=sys.stderr)
        return 3
    spans: dict[str, list] = {}
    for sp in run.spans:
        spans.setdefault(f"{sp['phase']}.{sp['name']}", []).append((sp["t1"] - sp["t0"]) * 1e3)
    print(json.dumps({"counters": {k: v for k, v in run.counters.items()
                                   if isinstance(v, (int, float))},
                      "span_ms": {k: [len(v), sum(v) / len(v), max(v)] for k, v in spans.items()}}),
          file=sys.stderr)
    side = "control" if run.control else "check"
    for name, c in result["checks"].items():
        print(f"{side} {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
