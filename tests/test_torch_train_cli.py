"""The port's training CLI and its files against novic_tpu on the CPU.

* The embedding cache: the port's writer produces files byte-identical to the
  JAX package's, and the two readers give identical batches for the same seed.
* `python -m novic_tpu_torch.cli.train action=train --device=cpu` trains a
  tiny decoder (the tests/test_cli.py sizes) and lowers the loss; its .npz
  (params and optimizer state) loads in novic_tpu's load_checkpoint +
  restore_opt_state, a JAX checkpoint resumes in the port, and resume
  continues the chunk counter.
* The JAX writer's native cache-I/O library is put in place whole before any
  test runs (see `_prebuild_native_cacheio`).
"""

import ctypes
import glob
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novic_tpu.cli.train import main as jax_main
from novic_tpu.data.cache import EmbeddingCache as JCache
from novic_tpu.data.cache import EmbeddingCacheWriter as JWriter
from novic_tpu.models.config import DecoderModelConfig as JConfig
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.text.simple import make_test_tokenizer as j_make_test_tokenizer
from novic_tpu.text.target import TargetTokenizer as JTargetTokenizer
from novic_tpu.text.target import create_target_config as j_create_target_config
from novic_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from novic_tpu.train.loop import restore_opt_state
from novic_tpu.train.optim import create_optimizer as j_create_optimizer
from novic_tpu.train.step import create_train_state
from novic_tpu_torch.bridge import ADAMW_HEAD
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.data.cache import EmbeddingCache, EmbeddingCacheWriter
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.text.target import TargetTokenizer, create_target_config
from novic_tpu_torch.train.checkpoint import load_checkpoint
from novic_tpu_torch.utils.misc import flatten_dict

torch.set_num_threads(2)
NOUNS = ["dog", "cat", "fire truck", "sea lion", "tree", "car", "hot dog", "apple"]


def _prebuild_native_cacheio():
    """Put novic_tpu's native cache-I/O library in place whole; return its path
    (None without a C++ compiler, when the JAX writer uses Python loops).

    novic_tpu/data/native.py compiles native/cacheio.cpp straight to its final
    name, native/_cacheio-<sha256[:12]>.so, with no lock, and loads that name
    whenever it exists: under pytest-xdist one worker can load another's
    half-written file ("file too short"). This module writes caches through
    that library, and every worker imports it while collecting, before any
    test runs; here the library is compiled with the same command into a
    temporary name and renamed into place, so `native._build` only ever finds
    a complete file."""
    src = Path(__file__).resolve().parents[1] / "native" / "cacheio.cpp"
    out = src.parent / f"_cacheio-{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}.so"
    if out.is_file():
        return out
    cc = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)), None)
    if cc is None:
        return None
    fd, tmp = tempfile.mkstemp(prefix="_cacheio-tmp-", suffix=".so", dir=src.parent)
    os.close(fd)
    try:
        subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", tmp, str(src)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


NATIVE_CACHEIO = _prebuild_native_cacheio()
F = 32
N = 320


def _data(seed=0, M=1):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(len(NOUNS), F)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Mostly one-word nouns, so some batches hold no 3-token target and get trimmed
    p = np.array([1.0 if " " not in n else 0.2 for n in NOUNS])
    idx = rng.choice(len(NOUNS), size=(N, M), p=p / p.sum())
    e = d[idx[:, 0]] + 0.05 * rng.normal(size=(N, F)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    ids = (idx + 1).astype(np.int32)
    weights = None
    if M > 1:  # descending weights summing to 1, trailing zero targets on most rows
        rows = np.arange(N)
        ids[rows % 4 != 0, 1:] = 0
        ids[rows % 8 != 0, 2:] = 0
        w = np.sort(rng.uniform(0.1, 1.0, size=(N, M)), axis=1)[:, ::-1]
        w = np.where(ids > 0, w, 0.0)
        weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    return e, ids, weights


def _write(writer_cls, tokenizer_fn, tc_fn, tt_cls, path, M, fixed):
    tok = tokenizer_fn(NOUNS)
    tc = tc_fn(tok, NOUNS, with_start_token=False, with_end_token=True, compact_ids=True,
               fixed_token_length=fixed, auto_fixed_token_length=True, use_masks=True)
    e, ids, w = _data(M=M)
    kw = dict(num_embed=N, embed_dim=F, target_tokenizer=tt_cls(tok, tc), target_nouns=NOUNS,
              num_embed_targets=M, shuffle=True, seed=3, embedder_strict=True,
              embedder_hash=bytes(range(32)))
    if M == 1:
        kw.update(default_weights=True)
    else:
        kw.update(default_weights=False, full_targets=False, unit_weights=True)
    with writer_cls(path, **kw) as writer:
        for i in range(0, N, 96):
            writer.write(e[i:i + 96], ids[i:i + 96], None if w is None else w[i:i + 96])
    return tc


@pytest.mark.parametrize("M,fixed", [(1, False), (3, False), (3, True)])
def test_cache_files_byte_identical_and_same_batches(tmp_path, M, fixed):
    jpath, ppath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jtc = _write(JWriter, j_make_test_tokenizer, j_create_target_config, JTargetTokenizer,
                 jpath, M, fixed)
    tc = _write(EmbeddingCacheWriter, make_test_tokenizer, create_target_config, TargetTokenizer,
                ppath, M, fixed)
    with open(jpath, "rb") as f1, open(ppath, "rb") as f2:
        assert f1.read() == f2.read()

    batches = []
    for cache_cls, t in ((JCache, jtc), (EmbeddingCache, tc)):
        cache = cache_cls(jpath, strict_embedder=False)
        cache.set_translation_source(t)
        ds = cache.create_dataset(batch_size=8, training=True)
        ds.configure_data(ds.resolve_data_config(multi_target=M > 1, use_weights=M > 1))
        loader, info = ds.create_loader(batch_size=8, training=True, seed=11)
        out = []
        with ds.loaded():
            for _ in range(2):  # two epochs: two circular offsets
                out.extend(tuple(None if x is None else np.array(x) for x in b) for b in loader)
        batches.append((out, info.epoch_batches))
    (jb, jn), (pb, pn) = batches
    assert jn == pn and len(jb) == len(pb) == 2 * jn
    shapes = set()
    for a, b in zip(jb, pb):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        shapes.add(a[1].shape)
    if not fixed:
        assert len(shapes) > 1  # trailing all-padding columns are trimmed per batch


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_cli")
    with open(d / "vocab.json", "w") as f:
        json.dump([{"target_noun": n} for n in NOUNS], f)
    _write(EmbeddingCacheWriter, make_test_tokenizer, create_target_config, TargetTokenizer,
           str(d / "cache.bin"), 1, False)
    return d


def _args(d, out):
    return ["embedder=test:32", f"vocab_path={d}/vocab.json", "seed=1", f"output_dir={d}/{out}",
            f"embedding_dataset={d}/cache.bin", "batch_size=8", "hidden_dim=32", "num_layers=2",
            "num_heads=4", "mlp_seq_len=2", "input_dropout=0.1", "layer_dropout=0.1",
            "init_lr=3e-3", "chunk_scale=4", "save_top1_min=200", "strict_embedder=false"]


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_on_cpu_lowers_loss_and_checkpoint_loads_in_jax(workdir):
    state, S, ewa = main(["action=train", "max_chunks=6", "save_every_max=3", "--device=cpu",
                          "noise_scheme=GaussElem", "noise_vec_norm=0.5", "accum_factor=2"]
                         + _args(workdir, "port"))
    assert S.chunk_id == 7
    ckpts = sorted(glob.glob(f"{workdir}/port/ovod_*/*.npz"))
    assert len(ckpts) == 2
    m = _metrics(os.path.dirname(ckpts[-1]))
    assert len(m) == 6 and all(np.isfinite(r["loss"]) for r in m)
    assert m[-1]["loss"] < m[0]["loss"]

    # The port's .npz in the JAX package: params, and the optax state restored
    jck = jax_load_checkpoint(ckpts[-1])
    jcfg = jck["model_config"]
    assert jcfg == JConfig.from_dict(load_checkpoint(ckpts[-1])["model_config"].as_dict())
    params = jax.tree.map(jnp.asarray, jck["params"])
    tx = j_create_optimizer(weight_decay=0.1, weight_decay_1d=False)
    jstate = restore_opt_state(create_train_state(params, tx), jck["opt_arrays"])
    adam = jstate.opt_state.inner_state[0]
    assert int(adam.count) == S.batch_id // 2 == state.step
    named = dict(state.model.named_parameters())
    for n, mu in flatten_dict(jax.tree.map(np.asarray, adam.mu)).items():
        np.testing.assert_array_equal(mu, state.optimizer.state[named[n]]["exp_avg"].numpy())
    for n, v in flatten_dict(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_array_equal(v, named[n].detach().numpy())
    # ...and it serves: the JAX decoder runs on the restored params
    out = JDecoder(cfg=jcfg).apply({"params": params}, jnp.zeros((2, F)), jnp.zeros((2, 3), jnp.int32))
    assert np.isfinite(np.asarray(out[0])).all()


def test_resume_continues_the_chunk_counter(workdir):
    ckpts = sorted(glob.glob(f"{workdir}/port/ovod_*/*.npz"))
    if not ckpts:
        main(["action=train", "max_chunks=3", "save_every_max=3", "--device=cpu"]
             + _args(workdir, "port"))
        ckpts = sorted(glob.glob(f"{workdir}/port/ovod_*/*.npz"))
    ck = load_checkpoint(ckpts[-1])
    start = ck["train_meta"]["loop_state"]["chunk_id"]
    _, S, _ = main(["action=train", f"max_chunks={start + 1}", "save_every_max=100",
                    f"load_model={ckpts[-1]}", "--device=cpu"] + _args(workdir, "port_resume"))
    assert S.chunk_id == start + 2


def test_jax_checkpoint_resumes_in_the_port(workdir):
    args = _args(workdir, "jax")
    jax_main(["action=train", "max_chunks=2", "save_every_max=2", "input_dropout=0.0",
              "layer_dropout=0.0"] + [a for a in args if "dropout" not in a])
    jckpts = sorted(glob.glob(f"{workdir}/jax/ovod_*/*.npz"))
    assert jckpts
    jck = jax_load_checkpoint(jckpts[-1])
    state, S, _ = main(["action=train", "max_chunks=3", "save_every_max=100",
                        f"load_model={jckpts[-1]}", "--device=cpu"] + args)
    assert S.chunk_id == 4
    jax_steps = int(jck["opt_arrays"][ADAMW_HEAD - 1])  # the adam count
    assert jax_steps == 8 and state.step == jax_steps + 4  # one more chunk of 4 batches


def test_not_ported_surfaces_raise(workdir, monkeypatch):
    # What still raises: CUDA absent. checkpoint_format=orbax, which raised
    # before the port had its own orbax code, writes .orbax directories; the
    # CLIPA conversion, which raised before its towers were ported, converts a
    # local CLIPA open_clip directory's state dict to novic_tpu's .npz
    main(["action=train", "checkpoint_format=orbax", "max_chunks=1", "save_every_max=1",
          "--device=cpu"] + _args(workdir, "orbax"))
    (saved,) = glob.glob(f"{workdir}/orbax/ovod_*/ovod_chunk*")
    assert saved.endswith(".orbax") and os.path.isdir(saved)
    assert load_checkpoint(saved)["train_meta"]["chunk_id"] == 1
    from test_clipa import CTX, D, E, L, P, S, V, make_openclip_clipa_sd

    from novic_tpu.embedders.convert import convert_openclip_state_dict, save_params_npz

    clipa = os.path.join(workdir, "clipa_ckpt")
    os.makedirs(clipa, exist_ok=True)
    with open(os.path.join(clipa, "open_clip_config.json"), "w") as f:
        json.dump({"embed_dim": D,
                   "vision_cfg": {"image_size": S, "layers": L, "width": E, "patch_size": P,
                                  "head_width": 8, "mlp_ratio": 2.0, "no_ln_pre": True,
                                  "pool_type": "avg", "final_ln_after_pool": True},
                   "text_cfg": {"context_length": CTX, "vocab_size": V, "width": E, "heads": 4,
                                "layers": L, "mlp_ratio": 2.0, "pool_type": "last",
                                "no_causal_mask": True,
                                "hf_tokenizer_name": "bert-base-uncased"}}, f)
    sd = make_openclip_clipa_sd(np.random.default_rng(2))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, f"{clipa}/model.bin")
    out = main(["action=convert_embedder", f"embedder=openclip:{clipa}",
                f"load_model={clipa}/model.bin", f"embedder_weights={workdir}/clipa.npz",
                "--device=cpu"])
    save_params_npz(f"{workdir}/clipa_jax.npz", *convert_openclip_state_dict(sd, "clipa", L, L))
    with np.load(out) as a, np.load(f"{workdir}/clipa_jax.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["action=train"] + _args(workdir, "x"))
    # Every action of the JAX CLI reaches the port's own action of the same
    # name, module for module, with the device: none is left "not ported"
    import importlib

    from novic_tpu.cli.train import build_action_registry as jax_registry
    from novic_tpu_torch.cli.train import build_action_registry

    jax_actions, port_actions = jax_registry(), build_action_registry()
    assert set(port_actions) == set(jax_actions)
    calls = []
    for name, fn in jax_actions.items():
        module = importlib.import_module(fn.__module__.replace("novic_tpu.", "novic_tpu_torch.", 1))
        assert getattr(module, fn.__name__) is port_actions[name]
        monkeypatch.setattr(module, fn.__name__,
                            lambda cfg, device="cuda": calls.append((cfg.action, device)))
    for name in sorted(jax_actions):
        main([f"action={name}", "--device=cpu"] + _args(workdir, "x"))
    assert calls == [(name, "cpu") for name in sorted(jax_actions)]


def test_native_cacheio_is_prebuilt_whole():
    """novic_tpu's `native._build` finds the library built above, and it loads."""
    from novic_tpu.data import native

    path = native._build()
    if NATIVE_CACHEIO is None:
        assert path is None
    else:
        assert Path(path) == NATIVE_CACHEIO
        ctypes.CDLL(str(NATIVE_CACHEIO))
