"""Milliseconds the training loop blocks on the loader's producer an
optimizer step: the program's `loader.wait` spans (BatchLoader's queue get),
summed per `train.step` span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "loader.wait", "train.step")
