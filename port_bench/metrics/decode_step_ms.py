"""Milliseconds the host takes to issue one beam step: the mean of the
program's `decode.step` spans (an iteration of generate_beam's loop)."""

from port_bench import program_spans


def read(run, name):
    recs = program_spans.traced(run)
    steps = program_spans.of(recs or [], "decode.step")
    return 1e3 * program_spans.seconds(steps) / len(steps) if steps else None
