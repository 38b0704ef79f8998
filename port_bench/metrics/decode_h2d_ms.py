"""Milliseconds the embeddings of a batch take to reach the decoder's
device: the program's `decode.h2d` spans (their float32 copy from the host),
per `decode` span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "decode.h2d", "decode")
