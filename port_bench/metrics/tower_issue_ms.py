"""Milliseconds the host spends issuing the vision tower a batch: the
program's `embed.forward` spans (the tower's forward on frames already on
the device, and any wait for room in a full launch queue), per `embed`
span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "embed.forward", "embed")
