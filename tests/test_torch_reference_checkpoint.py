"""Reference torch checkpoints (.model / .train) in the port
(novic_tpu_torch.train.checkpoint, bridge.adamw_state_from_reference, the
action=train resume and save_torch_checkpoints, NOVICModel) against
novic_tpu on the CPU.

* The state-dict name map equals novic_tpu's both ways, for each layout of
  the embedding MLP's nn.Sequential.
* A .model written by either package loads in the other: params, model and
  target config, nouns and cfg_flat equal. NOVICModel serves a .model as it
  serves the same float32 params in a .npz, taking the embedder spec from
  its cfg_flat.
* The restricted read: the files novic_tpu's reader refuses (a class outside
  the reference's audit, builtins.eval) are refused; the one it accepts (bf16,
  0-d, strided, nested) loads with the same values.
* A reference .train with AdamW moments, built as the reference builds its
  optimizer (tests/test_train.py::test_reference_adamw_state_conversion),
  gives the port's AdamW state whose optax leaves equal novic_tpu's grafted
  state, each moment on the parameter of its name; a .train the port writes
  gives novic_tpu the same leaves.
* One chunk resumed from a .train through each package's CLI (dropout off)
  gives the same losses and params within tests/test_torch_train.py's
  tolerance; save_torch_checkpoints writes a .model beside each .npz.
"""

import glob
import io
import os
import pickle
import zipfile

import jax
import numpy as np
import pytest
import torch

from novic_tpu.cli.train import main as jax_main
from novic_tpu.models import create_decoder as j_create_decoder
from novic_tpu.models.config import DecoderModelConfig as JConfig
from novic_tpu.text.simple import make_test_tokenizer as j_make_test_tokenizer
from novic_tpu.text.target import create_target_config as j_create_target_config
from novic_tpu.train import checkpoint as jck
from novic_tpu.train.torch_pickle import load_torch_pickle
from novic_tpu_torch.bridge import (
    adamw_state_from_reference,
    adamw_state_to_leaves,
    decoder_from_numpy,
)
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.infer import NOVICModel
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.text.target import create_target_config
from novic_tpu_torch.train import checkpoint as ck
from novic_tpu_torch.train.optim import create_optimizer
from novic_tpu_torch.utils.misc import flatten_dict
from test_torch_train_cli import _args, _metrics
from test_torch_train_cli import workdir  # noqa: F401 (fixture)

torch.set_num_threads(2)
NOUNS = ["dog", "cat", "fire truck", "sea lion", "tree", "car", "hot dog", "apple"]
F = 32
RTOL, PARAM_ATOL = 1e-5, 1e-6  # tests/test_torch_train.py's
MLP_LAYOUTS = {"none": dict(mlp_hidden_layer="none"),
               "hidden_norm": dict(mlp_hidden_layer="max", mlp_hidden_norm=True),
               "hidden": dict(mlp_hidden_layer="max", mlp_hidden_norm=False)}


def _target_configs():
    kw = dict(with_start_token=False, with_end_token=True, compact_ids=True,
              fixed_token_length=False, auto_fixed_token_length=True, use_masks=True)
    return (create_target_config(make_test_tokenizer(NOUNS), NOUNS, **kw),
            j_create_target_config(j_make_test_tokenizer(NOUNS), NOUNS, **kw))


def _params(layout: str = "none", seed: int = 3):
    """(port config, JAX config, float32 param tree) of a small decoder."""
    tc, _ = _target_configs()
    kw = dict(embed_dim=F, vocab_size=tc.vocab_size, token_length=tc.token_length, hidden_dim=32,
              feedfwd_scale="1/4", num_layers=2, num_heads=4, mlp_seq_len=2,
              input_dropout=0.0, layer_dropout=0.0, **MLP_LAYOUTS[layout])
    jcfg = JConfig(**kw)
    _, params = j_create_decoder(jcfg, rng=jax.random.PRNGKey(seed))
    return DecoderModelConfig(**kw), jcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _assert_trees_equal(a: dict, b: dict):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("layout", list(MLP_LAYOUTS))
def test_name_map_equals_jax(layout):
    cfg, jcfg, params = _params(layout)
    sd, jsd = ck.params_to_torch_state_dict(params, cfg), jck.params_to_torch_state_dict(params, jcfg)
    assert list(sd) == list(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    assert "causality_mask" in sd
    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    back = ck.torch_state_dict_to_params(tsd, cfg)
    _assert_trees_equal(back, jck.torch_state_dict_to_params(tsd, jcfg))
    _assert_trees_equal(back, params)
    # bf16 tensors widen to float32 exactly
    bf = ck.torch_state_dict_to_params({k: v.to(torch.bfloat16) for k, v in tsd.items()}, cfg)
    for k, v in flatten_dict(bf).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(
            v, torch.tensor(flatten_dict(params)[k]).to(torch.bfloat16).float().numpy())


def _save_model(writer: str, path: str, layout: str = "none"):
    cfg, jcfg, params = _params(layout)
    tc, jtc = _target_configs()
    cfg_flat = {**cfg.as_dict(), "embedder": f"test:{F}"}
    kw = dict(params=params, target_nouns=("",) + tuple(NOUNS), num_invalid_target_nouns=1,
              cfg_flat=cfg_flat, data_config={"multi_target": False})
    if writer == "port":
        ck.save_reference_checkpoint(path, model_config=cfg, target_config=tc, **kw)
    else:
        jck.save_reference_checkpoint(path, model_config=jcfg, target_config=jtc, **kw)
    return cfg, params, tc, cfg_flat


@pytest.mark.parametrize("writer,layout", [("jax", "none"), ("port", "none"),
                                           ("jax", "hidden_norm"), ("port", "hidden")])
def test_model_file_cross_loads(tmp_path, writer, layout):
    path = str(tmp_path / "ovod_chunk0001_test.model")
    cfg, params, tc, cfg_flat = _save_model(writer, path, layout)
    for loaded in (ck.load_reference_checkpoint(path), jck.load_reference_checkpoint(path)):
        _assert_trees_equal(jax.tree.map(np.asarray, loaded["params"]), params)
        assert loaded["model_config"].as_dict() == cfg.as_dict()
        assert loaded["target_config"].as_jsonable() == tc.as_jsonable()
        assert loaded["target_nouns"] == ("",) + tuple(NOUNS)
        assert loaded["num_invalid_target_nouns"] == 1
        assert loaded["cfg_flat"] == cfg_flat
        assert loaded["train_meta"] == {}
    assert ck.load_reference_checkpoint(path)["opt_moments"] is None
    # The schema the reference's loader reads: torch dtypes and tensors
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert isinstance(raw["target_config"]["token_dtype"], torch.dtype)
    assert isinstance(raw["target_config"]["compact_map"], torch.Tensor)
    assert raw["model_state_dict"]["causality_mask"].shape == (cfg.max_seq_len,) * 2


def test_novic_model_serves_a_model_file(tmp_path):
    """NOVICModel (CPU) on a .model: the embedder spec from its cfg_flat, the
    labels and logprobs of the same float32 params served from a .npz."""
    path = str(tmp_path / "ovod_chunk0001_test.model")
    cfg, params, tc, cfg_flat = _save_model("port", path)
    npz = str(tmp_path / "same.npz")
    ck.save_checkpoint(npz, params=params, cfg_flat=cfg_flat, model_config=cfg, target_config=tc,
                       data_config={}, target_nouns=("",) + tuple(NOUNS),
                       num_invalid_target_nouns=1)
    embeds = np.random.default_rng(0).normal(size=(4, F)).astype(np.float32)
    embeds /= np.linalg.norm(embeds, axis=1, keepdims=True)
    outs = []
    for p in (path, npz):
        with NOVICModel(p, device="cpu") as model:
            assert model.embedder.spec == f"test:{F}"
            outs.append(model.classify_embeds(embeds))
    assert outs[0].preds == outs[1].preds
    np.testing.assert_allclose(outs[0].logprobs, outs[1].logprobs, rtol=0, atol=1e-6)


# -- the restricted read -------------------------------------------------------------


def test_refuses_classes_outside_the_audit(tmp_path):
    import collections

    path = str(tmp_path / "evil.model")
    torch.save({"x": collections.Counter(a=1)}, path)  # torch's own allowlist admits it
    with pytest.raises(pickle.UnpicklingError, match="Refusing"):
        ck.read_reference_pickle(path)
    with pytest.raises(pickle.UnpicklingError, match="Refusing"):
        ck.load_reference_checkpoint(path)
    with pytest.raises((pickle.UnpicklingError, AttributeError)):
        load_torch_pickle(path)  # novic_tpu refuses it too


@pytest.mark.parametrize("form", ["bare_zip", "torch_zip"])
def test_refuses_builtins_eval(tmp_path, form):
    """novic_tpu's crafted data.pkl (GLOBAL builtins.eval; REDUCE), alone in a
    zip and inside a complete torch.save archive: refused, never run."""
    sentinel = str(tmp_path / "pwned")
    arg = f"open({sentinel!r}, 'w').close()"
    payload = (b"\x80\x02cbuiltins\neval\n(X" + len(arg).to_bytes(4, "little") + arg.encode()
               + b"tR.")
    path = str(tmp_path / "rce.train")
    if form == "bare_zip":
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("archive/data.pkl", payload)
        errors = (pickle.UnpicklingError, RuntimeError)  # torch: no "version" record
    else:
        buf = io.BytesIO()
        torch.save({"a": 1}, buf)
        with zipfile.ZipFile(io.BytesIO(buf.getvalue())) as src, \
                zipfile.ZipFile(path, "w") as dst:
            for info in src.infolist():
                data = src.read(info)
                dst.writestr(info, payload if info.filename.endswith("/data.pkl") else data)
        errors = pickle.UnpicklingError
    with pytest.raises(errors):
        ck.load_reference_checkpoint(path)
    with pytest.raises((pickle.UnpicklingError, ValueError)):  # ValueError: "unreadable"
        NOVICModel._peek_embedder_spec(path)
    assert not os.path.exists(sentinel)


def test_accepts_what_jax_accepts(tmp_path):
    ckpt = {
        "cfg_flat": {"init_lr": 1.5e-3, "model": "PrefixedIterDecoder"},
        "target_config": {"vocab_size": 7, "compact_map": torch.arange(10, dtype=torch.int32),
                          "start_token_id": None, "token_dtype": torch.int32},
        "model_state_dict": {"w": torch.randn(7, 16), "wb": torch.randn(8, 4).to(torch.bfloat16),
                             "scale": torch.tensor(0.5)},
        "strided": torch.randn(4, 6).t(),
        "nested": [(1, "a"), {"k": 2.5}],
    }
    path = str(tmp_path / "ref.model")
    torch.save(ckpt, path)
    ours, theirs = ck.read_reference_pickle(path), load_torch_pickle(path)
    assert ours["cfg_flat"] == theirs["cfg_flat"]
    assert ours["nested"] == [(1, "a"), {"k": 2.5}]
    np.testing.assert_array_equal(ours["target_config"]["compact_map"].numpy(),
                                  theirs["target_config"]["compact_map"])
    for k, v in theirs["model_state_dict"].items():
        np.testing.assert_array_equal(ck._to_numpy(ours["model_state_dict"][k]),
                                      np.asarray(v, np.float32))
    np.testing.assert_array_equal(ours["strided"].numpy(), theirs["strided"])


# -- reference AdamW moments ----------------------------------------------------------


def _reference_train(path: str, cfg, params, cfg_flat: dict, loop_state: dict,
                     weight_decay_1d: bool, lr: float = 1e-3):
    """A .train as the reference writes one after one optimizer step: torch AdamW
    over the groups [1-D no decay, N-D decay] (one group with weight_decay_1d),
    each in state-dict order, distinct gradients per param. Returns the torch
    state dict (stepped params) and the optimizer."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)).clone()
          for k, v in ck.params_to_torch_state_dict(params, cfg).items()}
    keys = [k for k in sd if k != "causality_mask"]
    for k in keys:
        sd[k].requires_grad_(True)
    if weight_decay_1d:
        groups = [{"params": [sd[k] for k in keys], "weight_decay": 0.1}]
    else:
        groups = [{"params": [sd[k] for k in keys if sd[k].dim() < 2], "weight_decay": 0.0},
                  {"params": [sd[k] for k in keys if sd[k].dim() >= 2], "weight_decay": 0.1}]
    opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.95))
    gen = torch.Generator().manual_seed(0)
    for k in keys:
        sd[k].grad = torch.randn(sd[k].shape, generator=gen)
    opt.step()
    tc, _ = _target_configs()
    ck.save_reference_checkpoint(
        path, params=ck.torch_state_dict_to_params({k: v.detach() for k, v in sd.items()}, cfg),
        model_config=cfg, target_config=tc, target_nouns=("",) + tuple(NOUNS),
        num_invalid_target_nouns=1, cfg_flat=cfg_flat, data_config={}, loop_state=loop_state)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    raw.update(optimizer_type="torch.optim.AdamW", optimizer_state_dict=opt.state_dict())
    torch.save(raw, path)
    return sd, opt


def _port_optimizer(loaded: dict, weight_decay_1d: bool):
    model = decoder_from_numpy(loaded["model_config"], loaded["params"])
    opt = create_optimizer(model.named_parameters(), beta1=0.9, beta2=0.95, weight_decay=0.1,
                           weight_decay_1d=weight_decay_1d)
    step = adamw_state_from_reference(model, opt, loaded["opt_moments"])
    return model, opt, step


@pytest.mark.parametrize("weight_decay_1d", [False, True])
def test_reference_adamw_moments_give_jax_leaves(tmp_path, weight_decay_1d):
    cfg, _, params = _params("hidden_norm")
    cfg_flat = {**cfg.as_dict(), "beta1": 0.9, "beta2": 0.95, "weight_decay": 0.1,
                "weight_decay_1d": weight_decay_1d}
    path = str(tmp_path / "adamw.train")
    sd, ref_opt = _reference_train(path, cfg, params, cfg_flat, {"chunk_id": 3},
                                   weight_decay_1d)
    jloaded = jck.load_reference_checkpoint(path)
    loaded = ck.load_reference_checkpoint(path)
    assert loaded["train_meta"]["loop_state"] == {"chunk_id": 3}
    model, opt, step = _port_optimizer(loaded, weight_decay_1d)
    assert step == 1
    leaves = adamw_state_to_leaves(model, opt, weight_decay_1d=weight_decay_1d)
    assert len(leaves) == len(jloaded["opt_arrays"])
    for a, b in zip(leaves, jloaded["opt_arrays"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # Each moment sits on the parameter of its name (independent of positions)
    named = dict(model.named_parameters())
    for k, p in sd.items():
        if k != "causality_mask":
            ours = ck._torch_key_to_ours(k, cfg)
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(opt.state[named[ours]][key].numpy(),
                                              ref_opt.state[p][key].numpy())
    # A .train the port writes from these moments gives novic_tpu the same leaves
    out = str(tmp_path / "port.train")
    ck.save_reference_checkpoint(
        out, params=loaded["params"], model_config=cfg, target_config=loaded["target_config"],
        target_nouns=loaded["target_nouns"], num_invalid_target_nouns=1, cfg_flat=cfg_flat,
        loop_state={"chunk_id": 3}, opt_moments=loaded["opt_moments"])
    for a, b in zip(jck.load_reference_checkpoint(out)["opt_arrays"], jloaded["opt_arrays"]):
        np.testing.assert_array_equal(a, b)


def test_partial_or_other_optimizer_state_restarts(tmp_path):
    cfg, _, params = _params()
    cfg_flat = {**cfg.as_dict(), "weight_decay_1d": False}
    path = str(tmp_path / "a.train")
    _reference_train(path, cfg, params, cfg_flat, {"chunk_id": 2}, False)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for mutate in ({"optimizer_type": "timm.optim.AdamP"},
                   {"optimizer_state_dict": {"state": {0: raw["optimizer_state_dict"]["state"][0]},
                                             "param_groups": []}}):
        torch.save({**raw, **mutate}, path)
        assert ck.load_reference_checkpoint(path)["opt_moments"] is None
        assert jck.load_reference_checkpoint(path)["opt_arrays"] is None


# -- resume through the CLIs -----------------------------------------------------------


def test_cli_resume_from_reference_train_matches_jax(workdir):  # noqa: F811
    args = [a for a in _args(workdir, "ref_base") if "dropout" not in a] + [
        "input_dropout=0.0", "layer_dropout=0.0"]
    main(["action=train", "max_chunks=1", "save_every_max=1", "--device=cpu"] + args)
    base = ck.load_checkpoint(sorted(glob.glob(f"{workdir}/ref_base/ovod_*/*.npz"))[-1])
    loop_state = base["train_meta"]["loop_state"]
    train_path = str(workdir / "ovod_chunk0001_ref.train")
    _reference_train(train_path, base["model_config"], base["params"], base["cfg_flat"],
                     loop_state, bool(base["cfg_flat"]["weight_decay_1d"]))
    chunk = loop_state["chunk_id"]
    resume = ["action=train", f"load_model={train_path}", f"max_chunks={chunk}",
              "save_every_max=1", "load_lr_state=false"]

    def run(out):
        return [a if not a.startswith("output_dir=") else f"output_dir={workdir}/{out}"
                for a in args]

    jax_main(resume + run("ref_jax"))
    state, S, _ = main(resume + ["save_torch_checkpoints=true", "--device=cpu"] + run("ref_port"))
    assert S.chunk_id == chunk + 1
    jnpz = sorted(glob.glob(f"{workdir}/ref_jax/ovod_*/*.npz"))[-1]
    pnpz = sorted(glob.glob(f"{workdir}/ref_port/ovod_*/*.npz"))[-1]
    jm, pm = _metrics(os.path.dirname(jnpz))[-1], _metrics(os.path.dirname(pnpz))[-1]
    for key in ("loss", "grad_norm_mean", "grad_norm_max"):
        assert abs(pm[key] - jm[key]) <= RTOL * abs(jm[key]), key
    jres, pres = jck.load_checkpoint(jnpz), ck.load_checkpoint(pnpz)
    jp, pp = flatten_dict(jres["params"]), flatten_dict(pres["params"])
    assert set(jp) == set(pp)
    for n in pp:
        np.testing.assert_allclose(pp[n], jp[n], atol=PARAM_ATOL, rtol=0, err_msg=n)
    # The optimizer resumed at the reference's step (1), and the hyperparameter
    # count restarted at 0 as novic_tpu grafts it
    assert state.step > 1
    assert int(pres["opt_arrays"][9]) == int(jres["opt_arrays"][9]) == state.step
    assert int(pres["opt_arrays"][0]) == int(jres["opt_arrays"][0]) == state.step - 1
    # save_torch_checkpoints: a .model beside the .npz, which novic_tpu reads
    model_path = pnpz[:-4] + ".model"
    assert os.path.isfile(model_path)
    _assert_trees_equal(jax.tree.map(np.asarray, jck.load_reference_checkpoint(model_path)["params"]),
                        pres["params"])


def test_checkpoint_dir_and_name(tmp_path):
    p = ck.checkpoint_dir_and_name(str(tmp_path), 7, stamp="s", kind="model")
    assert p == jck.checkpoint_dir_and_name(str(tmp_path), 7, stamp="s", kind="model")
    assert p.endswith(os.path.join("ovod_s", "ovod_chunk0007_s.model"))
    assert os.path.isdir(os.path.dirname(p))
