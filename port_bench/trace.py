"""The traced segment of a `--trace 1` run: torch.profiler over a fixed
amount of the cell's work, reduced to what the per-layer readers and the
result's `breakdown` need.

The profiler records the device's activity only (kernels, copies, sets):
recording every host operation as well would slow the launch-bound host
and so inflate the very idle share it measures. The idle gaps are labelled
by the benchmark's own host-clock spans instead. A marker kernel
(`torch.cuda._sleep`), launched on the idle device when the segment starts,
ties the trace's clock to the host's. The Chrome trace is written under
TMPDIR, read back and deleted. From it:

* busy_s: the union of the device intervals inside the segment, window_s:
  the segment's length on the host's clock;
* device_ops: the device operations by name with their summed seconds;
* idle_gaps: the seconds with no device operation running, each gap
  labelled by the innermost benchmark span the host was in at its middle
  (`host` where none, `unaligned` where the trace holds no marker);
* kernels: (name, seconds) of each device operation, for the rooflines.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 1000


def profile(fn: Callable[[], None], host_spans: Callable[[], list]) -> dict:
    """Run fn() under torch.profiler (device activity; host activity on a
    machine without CUDA) and return the reduced trace; host_spans() gives
    the (t0, t1, name) spans on the perf_counter clock that fn recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.cuda.is_available()
    with torch_profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        if cuda:
            torch.cuda.synchronize()
        h0 = time.perf_counter()
        if cuda:
            torch.cuda._sleep(MARKER_CYCLES)
        fn()
        if cuda:
            torch.cuda.synchronize()
        h1 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        reduced = reduce_events(events, h0, h1, host_spans())
        reduced["read_s"] = time.perf_counter() - t0
        return reduced
    finally:
        os.remove(path)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: list[dict], h0: float, h1: float, spans: list) -> dict:
    """Reduce Chrome-trace events (ts and dur in microseconds) of a segment
    that ran from h0 to h1 on the host's clock (seconds), with the host's
    spans (t0, t1, name) in it."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marker = next((e for e in sorted(device, key=lambda e: e["ts"])
                   if MARKER in str(e.get("name", ""))), None)
    device = [e for e in device if e is not marker]
    if marker is None and not device:
        return {"busy_s": 0.0, "window_s": h1 - h0, "kernels": [], "device_ops": [],
                "idle_gaps": [], "aligned": False}
    # The marker starts as it is launched, on an idle device: the trace's time of h0
    m = marker["ts"] if marker is not None else min(e["ts"] for e in device)
    w0, w1 = m, m + (h1 - h0) * 1e6
    dev = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1), e["name"]) for e in device]
    dev = [d for d in dev if d[1] > d[0]]
    busy = _union([(a, b) for a, b, _ in dev])
    by_name: dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    inner = sorted(((m + (a - h0) * 1e6, m + (b - h0) * 1e6, n) for a, b, n in spans),
                   key=lambda s: s[1] - s[0])
    gaps: dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = ("unaligned" if marker is None
                 else next((s[2] for s in inner if s[0] <= mid < s[1]), "host"))
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "window_s": h1 - h0,
            "kernels": [[n, s] for n, s in by_name.items()],
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10],
            "aligned": marker is not None}
