"""Milliseconds of host work after a batch's search, with the device
drained: the program's `decode.finish` spans (detokenization, the guide and
vocab look-ups, statistics and the output lists), per `decode` span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "decode.finish", "decode")
