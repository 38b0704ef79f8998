"""Milliseconds a training step waited for its batches: the benchmark's span
around fetching an optimizer step's `accum` batches from the port's loader
and concatenating them, averaged over the window's steps."""

import numpy as np


def read(run, name):
    spans = run.spans_of("loader")
    return float(np.mean([s["t1"] - s["t0"] for s in spans]) * 1e3) if spans else None
