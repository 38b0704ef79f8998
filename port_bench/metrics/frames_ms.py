"""Milliseconds a batch's frames take on the host before the tower: the
program's `embed.frames` spans (np.stack of the uint8 frames, their copy to
the device, issuing the normalisation), per `embed` span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "embed.frames", "embed")
