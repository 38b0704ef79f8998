"""Milliseconds per batch of NOVICModel.classify_embeds: the decoder's
search and detokenization (benchmark spans)."""

import numpy as np


def read(run, name):
    spans = run.spans_of("decode")
    return float(np.mean([s["t1"] - s["t0"] for s in spans]) * 1e3) if spans else None
