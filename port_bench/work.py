"""The work of one image or group in each cell, in FLOP by precision, for
the `mfu` and roofline readers: the tower's products at the bf16 peak, the
decoder's float32 products (TF32 off) at the float32 peak."""

from __future__ import annotations

import functools

import numpy as np

from port_bench import bounds


@functools.lru_cache(maxsize=4)
def target_positions(checkpoint: str) -> np.ndarray:
    """Scored positions (tokens and the end token, at most G) of each of
    the checkpoint's target nouns."""
    from port_bench.reference.decoder import read_checkpoint, LabelTokens

    _, meta = read_checkpoint(checkpoint)
    labels = LabelTokens(meta)
    G = int(meta["model_config"]["token_length"]) - 1
    return np.asarray([min(len(labels.encode(n)) + 1, G) for n in labels.nouns], np.int64)


def decoder_flops(run) -> int:
    """FLOP of one image's decode under the mix's gencfg."""
    d, gencfg = run.config["decoder"], run.mix["gencfg"]
    if gencfg.startswith("all"):
        return bounds.all_flops(d, target_positions(str(run.root / d["checkpoint"])))
    if gencfg.startswith("beam"):
        return bounds.beam_flops(d, int(gencfg.split("_k", 1)[1].split("_", 1)[0]))
    raise ValueError(f"no FLOP count for gencfg {gencfg}")


def peak_seconds(run, images: int) -> float:
    """Seconds the work of `images` images takes at the card's peaks."""
    return images * (bounds.tower_flops(run.config["tower"]) / bounds.BF16_FLOP_PER_S
                     + decoder_flops(run) / bounds.FP32_FLOP_PER_S)
