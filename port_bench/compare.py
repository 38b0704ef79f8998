"""The comparison that decides `correct`, and its lower-precision control.

A driver hands over the sampled rows of its window: the frames, the
program's embeddings, the token rows it scored (ids, padding), the labels
and scores it returned, the guide (guided gencfgs). Compared, each against
its limit in port_bench/limits/<workload>.json:

* embed_gap: max over rows of 1 - cos(program, reference embedding): the
  preprocessing and the vision tower, from the same frames and weights;
* score_gap: max |program score - reference score| over every returned
  label, teacher-forced through the reference decoder on the program's
  embedding (the decoder stage, checked from the program's own input);
* label_mismatch: returned labels that are not the decoding of the token
  row the program scored (exact: limit 0);
* off_guide (guided gencfgs): returned labels outside the guide (limit 0);
* missed_targets (exhaustive): targets the program did not return whose
  reference score lies above the lowest returned label's by more than a
  tie, twice score_gap's limit (two scores each within that limit of the
  reference may swap by that much); an exact count, limit 0.

A training cell (compare_train) is held to the reference's first steps
from the same start, batches and seeds (reference/train.py):
* loss_gap: max over the steps of |program - reference| / reference mean loss;
* grad_gap: max over the leaves of the gap between the norms of the first
  clipped gradient (the program's: its AdamW first moment after step 1 over
  1 - beta1) over the larger of the reference leaf's norm and the median's;
* delta_gap: the same of the parameters' change over the steps, on the
  leaves whose reference gradient is at least a thousandth of the median's;
* loader_mismatch: rows of those batches that are not rows the benchmark
  wrote (the driver checks the loader stage by itself; limit 0).

The control puts the reference in the program's place at the next lower
precision: the tower as its family module's CONTROL says, through the
program's own int8 path ("int8": SigLIP) or the reference with float8 e4m3
operands ("fp8": EVA02); the
decoder's products with TF32 operands. `control` returns its readings of
embed_gap, score_gap and (exhaustive) missed_targets, or of a training
cell's loss_gap, grad_gap and delta_gap; with `Run.control` the harness
judges them by the cell's limits in place of the program's.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.harness import (CellError, check_entry, checkpoint_path, cosine_gap,
                                family_module, free_device, reference_embeddings)
from port_bench.reference.decoder import ReferenceDecoder, read_checkpoint


def _missed_targets(dec: ReferenceDecoder, embeds: torch.Tensor,
                    returned_rows: list[list[int]], tie: float) -> int:
    missed = 0
    for i, returned in enumerate(returned_rows):
        if returned:
            full = dec.score_all(embeds[i])
            missed += int((np.delete(full, returned) > full[returned].min() + tie).sum())
    return missed


def compare(run, inp: dict) -> dict:
    limits = run.limits
    ref_e = reference_embeddings(run, inp["frames"])
    checks = {"embed_gap": check_entry(cosine_gap(inp["port_e"], ref_e.cpu()), limits["embed_gap"])}
    del ref_e
    free_device()
    dec = ReferenceDecoder(str(checkpoint_path(run)), run.device)
    port_t = torch.from_numpy(inp["port_e"])
    ref_scores = dec.score_rows(port_t, inp["ids"], inp["pad"])
    checks["score_gap"] = check_entry(np.abs(ref_scores - inp["scores"]).max(), limits["score_gap"])
    ids, preds = inp["ids"], inp["preds"]
    mismatch = sum(dec.labels.decode(ids[i, k]) != preds[i][k]
                   for i in range(ids.shape[0]) for k in range(ids.shape[1]))
    checks["label_mismatch"] = check_entry(mismatch, limits["label_mismatch"])
    if inp["guide"] is not None:
        off = sum(p not in inp["guide"] for row in preds for p in row)
        checks["off_guide"] = check_entry(off, limits["off_guide"])
    if inp["exhaustive"]:
        index = {n: j for j, n in enumerate(dec.labels.nouns)}
        returned = [[index[p] for p in row if p in index] for row in preds]
        checks["missed_targets"] = check_entry(
            _missed_targets(dec, port_t, returned, 2 * limits["score_gap"]),
            limits["missed_targets"])
    return checks


def _train_readings(run, inp: dict, tf32: bool) -> tuple[dict, dict]:
    """(readings, reference state) of the reference's first steps against
    the program's record; with tf32 the control's against the reference's."""
    from port_bench.reference.train import ReferenceTrainer

    ckpt = str(checkpoint_path(run))
    rec = inp["check"]
    ref = ReferenceTrainer(ckpt, run.device, run.mix, inp["rng_seed"])
    ctl = ReferenceTrainer(ckpt, run.device, run.mix, inp["rng_seed"], tf32=True) if tf32 else None
    loss_gap, g_ref, g_side = 0.0, None, None
    for i, batch in enumerate(rec["batches"]):
        loss_ref, grads = ref.step(batch, run.mix["lr"])
        if ctl is None:
            m = rec["metrics"][i]
            loss = float(np.sum(m["loss_sum"]) / np.sum(m["loss_basis"]))
            side = None
        else:
            loss, side = ctl.step(batch, run.mix["lr"])
        loss_gap = max(loss_gap, abs(loss - loss_ref) / abs(loss_ref))
        if i == 0:
            g_ref = {k: float(g.norm()) for k, g in grads.items()}
            g_side = ({k: float(g.norm()) for k, g in rec["grad"].items()} if side is None
                      else {k: float(g.norm()) for k, g in side.items()})
    start = {k: torch.from_numpy(a.astype(np.float32)).to(run.device)
             for k, a in read_checkpoint(ckpt)[0].items()}
    d_ref = {k: float((ref.p[k].detach() - start[k]).norm()) for k in start}
    d_side = ({k: float((rec["end"][k] - rec["start"][k]).norm()) for k in start} if ctl is None
              else {k: float((ctl.p[k].detach() - start[k]).norm()) for k in start})
    med_g = float(np.median(list(g_ref.values())))
    counted = [k for k in start if g_ref[k] >= 1e-3 * med_g]
    med_d = float(np.median([d_ref[k] for k in counted]))
    return {"loss_gap": loss_gap,
            "grad_gap": max(abs(g_side[k] - g_ref[k]) / max(g_ref[k], med_g) for k in g_ref),
            "delta_gap": max(abs(d_side[k] - d_ref[k]) / max(d_ref[k], med_d) for k in counted)}


def compare_train(run, inp: dict) -> dict:
    readings = _train_readings(run, inp, tf32=False)
    checks = {k: check_entry(v, run.limits[k]) for k, v in readings.items()}
    checks["loader_mismatch"] = check_entry(inp["loader_mismatch"], run.limits["loader_mismatch"])
    return checks


def control(run, inp: dict) -> dict:
    """The control's readings of the numbers it gives, at the sampled rows."""
    from port_bench.harness import port_model

    if inp.get("train"):
        return _train_readings(run, inp, tf32=True)
    ref_e = reference_embeddings(run, inp["frames"]).cpu()
    kind = family_module(run.config["tower"], run.root).CONTROL
    if kind == "int8":
        model = port_model(run, run.mix.get("batch", run.mix.get("model_batch_size")),
                           run.mix["gencfg"], quant="int8")
        ctl_e = model.embed_images(list(inp["frames"]))
        model.__exit__(None, None, None)
        del model
    elif kind == "fp8":
        ctl_e = reference_embeddings(run, inp["frames"], fp8=True).cpu()
    else:
        raise CellError(f"tower family {run.config['tower']['family']}: no control {kind!r}")
    free_device()
    out = {"embed_gap": cosine_gap(ctl_e, ref_e)}
    ckpt = str(checkpoint_path(run))
    dec, ctl = ReferenceDecoder(ckpt, run.device), ReferenceDecoder(ckpt, run.device, tf32=True)
    port_t = torch.from_numpy(inp["port_e"])
    out["score_gap"] = float(np.abs(ctl.score_rows(port_t, inp["ids"], inp["pad"])
                                    - dec.score_rows(port_t, inp["ids"], inp["pad"])).max())
    if inp["exhaustive"]:
        returned = [list(np.argsort(-ctl.score_all(port_t[i]))[:inp["ids"].shape[1]])
                    for i in range(port_t.shape[0])]
        out["missed_targets"] = _missed_targets(dec, port_t, returned, 2 * run.limits["score_gap"])
    return out
