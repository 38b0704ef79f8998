"""Specificity-weighted prediction scoring (parity with reference
extras/specificity/specificity_scores.py): overall score = mean over samples of
category_weight(prediction) × specificity_factor(prediction), using a
per-noun specificity annotations JSON ({noun: factor}).

The port's copy of novic_tpu.tools.specificity, with the same
functions and names. It runs no kernel and touches no device.
"""

from __future__ import annotations

import json

from novic_tpu_torch.cli.actions_eval import CATEGORY_WEIGHTS


def default_specificity_path() -> str:
    """The released per-noun specificity annotations shipped with the repo
    (verbatim copy of reference extras/specificity/_specificity_annotations.json;
    5,547 entries -> factor in {0.5, 1.0}, incl. a ""->0.5 fallback row)."""
    import os

    from novic_tpu_torch.utils.config import source_dir
    return os.path.join(source_dir(), "data", "specificity_annotations.json")


def specificity_score(predictions: dict, annotations: dict,
                      specificity: dict[str, float],
                      default_factor: float = 1.0) -> dict:
    """predictions: action=infer JSON; annotations: {sample: {category: [nouns]}};
    specificity: {noun: factor}. Returns per-model×gencfg scores."""
    import os

    results = {}
    sample_keys = [os.path.basename(k) for k in predictions["keys"]]
    for model_name, model_out in predictions["models"].items():
        for gname, gout in model_out["gencfgs"].items():
            total = count = 0.0
            for sk, preds in zip(sample_keys, gout["pred"]):
                ann = annotations.get(sk)
                if ann is None:
                    continue
                pred = preds[0]
                weight = 0.0
                for category, nouns in ann.items():
                    if category in CATEGORY_WEIGHTS and pred in nouns:
                        weight = max(weight, CATEGORY_WEIGHTS[category])
                total += weight * specificity.get(pred, default_factor)
                count += 1
            results[(model_name, gname)] = total / max(count, 1)
    return results


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Specificity-weighted prediction scores")
    p.add_argument("--predictions", required=True)
    p.add_argument("--annotations", required=True)
    p.add_argument("--specificity", default=default_specificity_path(),
                   help="per-noun specificity JSON (default: shipped released asset)")
    a = p.parse_args()
    with open(a.predictions) as f:
        preds = json.load(f)
    with open(a.annotations) as f:
        anns = json.load(f)
    with open(a.specificity) as f:
        spec = json.load(f)
    for (model, gencfg), score in specificity_score(preds, anns, spec).items():
        print(f"{model} {gencfg}: {score:.4f}")
