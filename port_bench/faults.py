"""Faults planted in the program's timed path, to show that `correct` comes
out false, and to read a training cell's numbers with each on the chip.

    python3 port_bench/faults.py --workload siglip_b16_ft0.train_cache \
        --seconds 5 --seeds 1501,1502,1503

Each fault is a context manager that patches the program while it is open:
* state_unchanged: the optimizer step moves its moments and leaves the
  parameters as they were;
* half_batch: every microbatch keeps its first half of the rows, the mean
  taken over those;
* token_altered: the decoder trains on another first target token than the
  batch holds;
* beam_token_altered (serving): beam search returns another first token;
* tower_half_batch (serving): the tower embeds half the batch and repeats it;
* decode_state_unchanged (serving): a decode step leaves its caches as they
  were;
* best_target_dropped (exhaustive): the search returns its ranks 2 to k+1,
  leaving out the best target.
One JSON line a fault and seed: the numbers compared, beside their limits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def state_unchanged():
    import torch

    real = torch.optim.AdamW.step

    def unchanged(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        kept = [p.detach().clone() for p in params]
        real(self, closure)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)

    with mock.patch.object(torch.optim.AdamW, "step", unchanged):
        yield


@contextlib.contextmanager
def half_batch():
    import novic_tpu_torch.train.step as step

    real = step._split

    def half(x, parts):
        return [None if p is None else p[: max(p.shape[0] // 2, 1)] for p in real(x, parts)]

    with mock.patch.object(step, "_split", half):
        yield


@contextlib.contextmanager
def token_altered():
    from novic_tpu_torch.models.prefixed_iter import PrefixedIterDecoder

    real = PrefixedIterDecoder.forward

    def altered(self, embed, target, *args, **kwargs):
        target = target.clone()
        target[:, 0] = (target[:, 0] % 50) + 1
        return real(self, embed, target, *args, **kwargs)

    with mock.patch.object(PrefixedIterDecoder, "forward", altered):
        yield


@contextlib.contextmanager
def beam_token_altered():
    import novic_tpu_torch.infer as infer

    real = infer.generate_beam

    def altered(*args, **kwargs):
        t, p, s = real(*args, **kwargs)
        t = t.clone()
        t[:, 0, 0] = (t[:, 0, 0] % 50) + 1
        return t, p, s

    with mock.patch.object(infer, "generate_beam", altered):
        yield


@contextlib.contextmanager
def tower_half_batch():
    from novic_tpu_torch.embedders.base import TorchEmbedder

    real = TorchEmbedder.inference_image

    def half(self, images):
        out = real(self, images[: (len(images) + 1) // 2])
        return np.concatenate([out, out])[: len(images)]

    with mock.patch.object(TorchEmbedder, "inference_image", half):
        yield


@contextlib.contextmanager
def decode_state_unchanged():
    from novic_tpu_torch.models.prefixed_iter import PrefixedIterDecoder

    real = PrefixedIterDecoder.decode_step_lazy

    def unchanged(self, token_ids, step, pk, pv, tk, tv, anc_bias):
        logits, _, _ = real(self, token_ids, step, pk, pv, [t.clone() for t in tk],
                            [t.clone() for t in tv], anc_bias)
        return logits, tk, tv

    with mock.patch.object(PrefixedIterDecoder, "decode_step_lazy", unchanged):
        yield


@contextlib.contextmanager
def best_target_dropped():
    import novic_tpu_torch.infer as infer

    real = infer.generate_all

    def dropped(model, embed, *, topk, **kwargs):
        t, p, s = real(model, embed, topk=topk + 1, **kwargs)
        return t[:, 1:], p[:, 1:], s[:, 1:]

    with mock.patch.object(infer, "generate_all", dropped):
        yield


TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch,
            "token_altered": token_altered}
SERVING = {"beam_token_altered": beam_token_altered, "tower_half_batch": tower_half_batch,
           "decode_state_unchanged": decode_state_unchanged}
EXHAUSTIVE = {"best_target_dropped": best_target_dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", default="", help="comma-separated fault names (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness
    from port_bench.run import cache_environment

    cache_environment(ROOT)
    cell = harness.load_cell(ROOT, args.workload)
    faults = (TRAINING if cell.mix["driver"] == "train"
              else {**SERVING, **EXHAUSTIVE} if cell.mix["gencfg"].startswith("all")
              else SERVING)
    if args.only:
        faults = {k: faults[k] for k in args.only.split(",")}
    for name, fault in faults.items():
        for seed in (int(s) for s in args.seeds.split(",")):
            with fault():
                result = harness.execute(harness.Run(ROOT, cell, seed, args.seconds, False))
            print(json.dumps({"fault": name, "seed": seed, "correct": result["correct"],
                              "checks": result["checks"]}), flush=True)
            harness.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
