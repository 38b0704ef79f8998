"""Milliseconds the host takes to issue a batch's prefill: the program's
`decode.prefill` spans (the prefix caches' prefill and the beam's first
state in generate_beam), per `decode` span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "decode.prefill", "decode")
