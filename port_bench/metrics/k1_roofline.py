"""K1's share of its roofline in the traced segment: the least time of
every K1 launch from its shape (attention_bound_ms, one launch per tower
layer per batch or group), over the device time of K1's two kernels (the
bf16 pre-pass and the attention kernel) by name in the profile (%). No
reading where the segment's K1 launches are not one per layer per forward."""

from port_bench import bounds


def read(run, name):
    tr = run.traced
    towers = [s for s in run.spans if s["name"] == "tower" and s["phase"] == "traced"]
    if tr is None or not towers:
        return None
    t = run.config["tower"]
    if run.counters.get("launches_traced", {}).get("attention") != t["layers"] * len(towers):
        return None
    S, hd = bounds.tower_tokens(t), t["width"] // t["heads"]
    bound_ms = sum(t["layers"] * bounds.attention_bound_ms(s["images"], S, t["heads"], hd, False)[0]
                   for s in towers)
    k1_s = sum(sec for n, sec in tr["kernels"] if any(k in n for k in bounds.K1_KERNELS))
    return 100.0 * bound_ms / 1e3 / k1_s if k1_s > 0 else None
