"""Share of the measured window in which no operation ran on the device
(%): the device's busy seconds per unit of work (a batch, or an optimizer
step) from the profiler's trace of the traced segment, times the window's
units, over the window's wall time. The traced segment's own idle share
(the result's busy_s over window_s) reads higher: the profiler's tracing
slows the launch-bound host, not the device's operations."""


def read(run, name):
    tr = run.traced
    if tr is None or tr["busy_s"] <= 0 or not run.window.get("elapsed_s"):
        return None
    unit = "step" if run.mix["driver"] == "train" else "decode"
    traced, window = len(run.spans_of(unit, "traced")), len(run.spans_of(unit))
    if not traced or not window:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / traced * window / run.window["elapsed_s"])
