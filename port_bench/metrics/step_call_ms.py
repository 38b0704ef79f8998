"""Milliseconds one call of the optimizer step holds the host: the mean of
the program's `train.step` spans (a call of the step train/step.py builds),
per optimizer step. The call issues the step's work and returns; once the
launch queue is full it waits for room, so where the device paces training
it lasts about the whole step."""

from port_bench import program_spans


def read(run, name):
    steps = program_spans.of(program_spans.traced(run) or [], "train.step")
    if not steps:
        return None
    return 1e3 * program_spans.seconds(steps) / sum(s["attrs"].get("steps", 1) for s in steps)
