"""Milliseconds per batch of NOVICModel.embed_images, preprocessing and
the vision tower; it returns numpy, so the span ends when the device is
done (benchmark spans)."""

import numpy as np


def read(run, name):
    spans = run.spans_of("tower")
    return float(np.mean([s["t1"] - s["t0"] for s in spans]) * 1e3) if spans else None
