"""Milliseconds the loader's producer thread works an optimizer step: the
program's `loader.produce` spans (reading a batch from the cache and its
pinned host copy), summed per `train.step` span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "loader.produce", "train.step")
