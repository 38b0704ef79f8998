"""Beam steps a decoded batch: the program's `decode.steps` counter per
`decode` span (the decoder's token_length less one)."""

from port_bench import program_spans


def read(run, name):
    return program_spans.counter_per(run, "decode.steps", "decode")
