"""Milliseconds the host waits on the vision tower a batch: the program's
`embed.wait` spans (the embeddings' copy to the host, which blocks until the
tower's device work ends), per `embed` span."""

from port_bench import program_spans


def read(run, name):
    return program_spans.ms_per(run, "embed.wait", "embed")
