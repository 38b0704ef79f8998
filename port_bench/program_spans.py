"""The program's own spans and counters (novic_tpu_torch/utils/trace.py) in
the traced segment of a `--trace 1` run, for the per-layer readers that read
them.

The program records only while a torch.profiler session runs, which in a run
is the traced segment alone. A reader takes the records that lie between the
first and the last of the harness's `traced`-phase spans, the producer
thread's included. Where the program has no such module or recorded nothing
there, the readers return None and the result line leaves the metric out.
"""

from __future__ import annotations

from typing import Optional


def _trace():
    try:
        from novic_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def traced(run) -> Optional[list[dict]]:
    """The program's span records inside the traced segment, or None."""
    trace = _trace()
    spans = [s for s in run.spans if s["phase"] == "traced"]
    if trace is None or not spans:
        return None
    lo, hi = min(s["t0"] for s in spans), max(s["t1"] for s in spans)
    return [r for r in trace.records() if lo <= r["t0"] and r["t1"] <= hi] or None


def of(records: list[dict], name: str) -> list[dict]:
    return [r for r in records if r["name"] == name]


def seconds(records: list[dict]) -> float:
    return sum(r["t1"] - r["t0"] for r in records)


def ms_per(run, name: str, unit: str) -> Optional[float]:
    """Milliseconds of the spans `name` summed over the segment, per span
    `unit` in it (per batch, per optimizer step)."""
    recs = traced(run)
    if recs is None:
        return None
    spans, units = of(recs, name), of(recs, unit)
    if not spans or not units:
        return None
    return 1e3 * seconds(spans) / len(units)


def counter_per(run, name: str, unit: str) -> Optional[float]:
    """The program's counter `name` per span `unit` of the segment (the
    program counts only while the segment's profiler runs)."""
    trace, recs = _trace(), traced(run)
    if trace is None or recs is None:
        return None
    value, units = trace.counters().get(name), of(recs, unit)
    return value / len(units) if value is not None and units else None
