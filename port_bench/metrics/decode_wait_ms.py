"""Milliseconds the host waits on the queued beam steps a batch: the
program's `decode.wait` spans (the results' copy to the host), per `decode`
span. Near 0 where the host, not the device, paces the decode."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "decode.wait", "decode")
