"""AdamP in the port (novic_tpu_torch.train.optim.AdamP, its optax leaves in
bridge.py, optimizer=AdamP through action=train) against novic_tpu's
transcription (novic_tpu.train.optim.adamp) on the CPU.

* Five steps on a scale-invariant 2-D parameter whose gradients are
  orthogonal to its rows (the channel view projects), one whose gradients are
  orthogonal to it as a whole but not row by row (the layer view projects),
  one with aligned gradients (no projection), a 3-D and a 1-D parameter;
  with and without Nesterov and weight_decay_1d: params within 1e-6 relative.
* The optimizer state as optax leaves equals novic_tpu's, and loads back.
* One chunk of action=train with optimizer=AdamP from the same params (dropout
  off) gives novic_tpu's losses, params and optimizer leaves.
"""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from novic_tpu.cli.train import main as jax_main
from novic_tpu.train import checkpoint as jck
from novic_tpu.train.optim import create_optimizer as j_create_optimizer
from novic_tpu_torch.bridge import ADAMP_HEAD, adamp_state_from_leaves, adamp_state_to_leaves
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.train.checkpoint import load_checkpoint
from novic_tpu_torch.train.optim import AdamP, create_optimizer
from novic_tpu_torch.utils.misc import flatten_dict
from test_torch_train_cli import _args, _metrics
from test_torch_train_cli import workdir  # noqa: F401 (fixture)

torch.set_num_threads(2)
REL = 1e-6
RTOL, PARAM_ATOL = 1e-5, 1e-6  # tests/test_torch_train.py's
LR, DELTA = 0.01, 0.1


def _cos_max(p: np.ndarray, g: np.ndarray, rows: int) -> float:
    pv, gv = p.reshape(rows, -1), g.reshape(rows, -1)
    cos = np.abs((pv * gv).sum(1)) / np.linalg.norm(pv, axis=1) / np.linalg.norm(gv, axis=1)
    return float(cos.max())


def _projection(p: np.ndarray, g: np.ndarray) -> str:
    """Which view projects at this step: channel, layer or none."""
    if _cos_max(p, g, p.shape[0]) < DELTA / math.sqrt(p[0].size):
        return "channel"
    if _cos_max(p, g, 1) < DELTA / math.sqrt(p.size):
        return "layer"
    return "none"


def _grads(kind: str, p: dict, rng) -> dict:
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    w = p["w"]
    if kind == "channel":   # each row orthogonal to the param's row
        rows = w / np.linalg.norm(w, axis=1, keepdims=True)
        g["w"] = g["w"] - rows * (rows * g["w"]).sum(axis=1, keepdims=True)
    elif kind == "layer":   # orthogonal to the param as a whole only
        flat = w.ravel() / np.linalg.norm(w)
        g["w"] = g["w"] - (flat * (flat * g["w"].ravel()).sum()).reshape(w.shape)
    else:                   # aligned with the param
        g["w"] = 0.5 * w + 0.05 * g["w"]
    return {k: v.astype(np.float32) for k, v in g.items()}


@pytest.mark.parametrize("kind,nesterov,wd_1d", [("channel", True, False), ("layer", True, False),
                                                 ("none", True, False), ("channel", False, False),
                                                 ("layer", True, True)])
def test_adamp_matches_jax(kind, nesterov, wd_1d):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8, 64)).astype(np.float32),
              "c": rng.normal(size=(3, 4, 5)).astype(np.float32),
              "b": rng.normal(size=(6,)).astype(np.float32)}
    tx = j_create_optimizer(optimizer="AdamP", weight_decay=0.1, weight_decay_1d=wd_1d,
                            nesterov=nesterov)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = create_optimizer(list(tp.items()), optimizer="AdamP", weight_decay=0.1,
                           weight_decay_1d=wd_1d, nesterov=nesterov)
    assert isinstance(opt, AdamP)
    for t in range(5):
        cur = jax.tree.map(np.asarray, jp)
        g = _grads(kind, cur, rng)
        assert _projection(cur["w"], g["w"]) == kind
        jstate.hyperparams["learning_rate"] = jnp.asarray(LR, jnp.float32)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.param_groups[0]["lr"] = LR
        opt.step()
        for k in params:
            ref = np.asarray(jp[k])
            assert np.abs(tp[k].detach().numpy() - ref).max() <= REL * np.abs(ref).max(), (t, k)

    # The state as optax leaves (params in flax order: b, c, w), and back
    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, p in tp.items():
                self.register_parameter(k, p)

    model = Holder()
    leaves, jleaves = adamp_state_to_leaves(model, opt), jax.tree.leaves(jstate)
    assert len(leaves) == len(jleaves) == ADAMP_HEAD + 2 * len(params)
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if i < ADAMP_HEAD:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=REL, atol=REL * np.abs(b).max())
    fresh = create_optimizer(model.named_parameters(), optimizer="AdamP", weight_decay=0.1)
    assert adamp_state_from_leaves(model, fresh, [np.asarray(x) for x in jleaves]) == 5
    for a, b in zip(adamp_state_to_leaves(model, fresh), jleaves):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_cli_chunk_with_adamp_matches_jax(workdir):  # noqa: F811
    args = [a for a in _args(workdir, "adamp_base") if "dropout" not in a] + [
        "input_dropout=0.0", "layer_dropout=0.0"]
    main(["action=train", "max_chunks=1", "save_every_max=1", "--device=cpu"] + args)
    base = sorted(glob.glob(f"{workdir}/adamp_base/ovod_*/*.npz"))[-1]

    def run(out):
        # lr 1e-4 as in tests/test_torch_train.py: Adam's first steps move an
        # element with a tiny gradient by ~lr * sign(g), float noise included
        return ["action=train", f"load_model={base}", "load_train_state=false",
                "optimizer=AdamP", "max_chunks=1", "save_every_max=1"] + [
            a if not a.startswith("output_dir=") else f"output_dir={workdir}/{out}"
            for a in args] + ["init_lr=1e-4"]

    jax_main(run("adamp_jax"))
    state, S, _ = main(run("adamp_port") + ["--device=cpu"])
    assert isinstance(state.optimizer, AdamP) and S.chunk_id == 2
    jnpz = sorted(glob.glob(f"{workdir}/adamp_jax/ovod_*/*.npz"))[-1]
    pnpz = sorted(glob.glob(f"{workdir}/adamp_port/ovod_*/*.npz"))[-1]
    jm, pm = _metrics(os.path.dirname(jnpz))[-1], _metrics(os.path.dirname(pnpz))[-1]
    for key in ("loss", "grad_norm_mean", "grad_norm_max"):
        assert abs(pm[key] - jm[key]) <= RTOL * abs(jm[key]), key
    jres, pres = jck.load_checkpoint(jnpz), load_checkpoint(pnpz)
    jp, pp = flatten_dict(jres["params"]), flatten_dict(pres["params"])
    assert set(jp) == set(pp)
    for n in pp:
        np.testing.assert_allclose(pp[n], jp[n], atol=PARAM_ATOL, rtol=0, err_msg=n)
    # The .npz's opt.* leaves in novic_tpu's AdamP order
    assert len(pres["opt_arrays"]) == len(jres["opt_arrays"])
    for i, (a, b) in enumerate(zip(pres["opt_arrays"], jres["opt_arrays"])):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if i < ADAMP_HEAD:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=PARAM_ATOL, err_msg=str(i))
    assert int(pres["opt_arrays"][ADAMP_HEAD - 1]) == state.step == S.batch_id - 1
