"""The tower's bf16 GEMM calls a batch: the program's `tower.dense` counter
per `embed` span (one a patch embedding and six a block: 193 in
DFN5B-H-14-378; the float32 projection is not counted). No reading where
the program has no such counter."""

from port_bench import program_spans


def read(run, name):
    return program_spans.counter_per(run, "tower.dense", "embed")
