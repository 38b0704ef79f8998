"""The training step's share of the card's float32 peak: the model FLOP of
the window's optimizer steps (forward and backward, three times the
forward's products: the embedding's projection, every layer's dense
products and its S x S attention, the logits of the C target positions)
at 67 TFLOP/s (TF32 off), over the window's wall time (%)."""

from port_bench import bounds


def read(run, name):
    steps = run.spans_of("step")
    if not steps:
        return None
    d, mix = run.config["decoder"], run.mix
    E, FF, L, P = d["hidden_dim"], d["feedfwd_dim"], d["num_layers"], d["mlp_seq_len"]
    flops = 0
    for s in steps:
        C = s["tokens"]
        S = P + C - 1
        fwd = (2 * d["embed_dim"] * P * E + S * L * (2 * 4 * E * E + 2 * 2 * E * FF)
               + L * 2 * 2 * S * S * E + C * 2 * E * d["vocab_size"])
        flops += 3 * fwd * mix["batch"] * mix["accum"]
    return 100.0 * flops / bounds.FP32_FLOP_PER_S / run.window["elapsed_s"]
