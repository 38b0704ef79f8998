"""LayerNorm kernel launches a batch: the program's `tower.layer_norm`
counter per `embed` span (two a block and the tower's final norms: 26 in
SigLIP-B/16 with its MAP head, 97 in EVA02-L/14 with sub-LN and SwiGLU's
norm). No reading where the program has no such counter."""

from port_bench import program_spans


def read(run, name):
    return program_spans.counter_per(run, "tower.layer_norm", "embed")
