"""The whole step's share of the card's peak: the window's work at the
peak of each part's precision (the tower's products at the bf16 peak, the
decoder's float32 products at the float32 peak), over the window's wall
time (%)."""

from port_bench import work


def read(run, name):
    towers = run.spans_of("tower")
    if not towers:
        return None
    images = sum(s["images"] for s in towers)
    return 100.0 * work.peak_seconds(run, images) / run.window["elapsed_s"]
