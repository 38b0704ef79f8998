"""Exhaustive decoding's share of its float32 bound: the model FLOP of a
batch's scoring over every target at the float32 peak, over the measured
decode span of a batch (%)."""

import numpy as np

from port_bench import bounds, work


def read(run, name):
    spans = run.spans_of("decode")
    if not spans or not run.mix["gencfg"].startswith("all"):
        return None
    d = run.config["decoder"]
    per_image = bounds.all_flops(d, work.target_positions(str(run.root / d["checkpoint"])))
    bound_s = np.mean([s["images"] for s in spans]) * per_image / bounds.FP32_FLOP_PER_S
    return 100.0 * bound_s / float(np.mean([s["t1"] - s["t0"] for s in spans]))
