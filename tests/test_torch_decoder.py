"""Port decoder (novic_tpu_torch.models) against the JAX decoder on the FT0 asset.

Both packages load assets/bench_ft0_decoder.npz (float16 on disk, float32 in
compute). prefill_split logits and three decode_step_lazy steps agree within
1e-5 relative: both compute in exact float32 and differ only in sum order.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from novic_tpu.models.config import DecoderModelConfig as JConfig
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from novic_tpu_torch.bridge import decoder_from_numpy, decoder_to_numpy
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.layers import NEG_INF
from novic_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(2)
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
RTOL = 1e-5


@pytest.fixture(scope="module")
def ft0():
    ck = load_checkpoint(FT0)
    jck = jax_load_checkpoint(FT0)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jck["params"])
    return ck, jck["model_config"], jparams


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= rtol * scale, (np.abs(a - b).max(), scale)


def test_config_round_trips(ft0):
    ck, jcfg, _ = ft0
    cfg = ck["model_config"]
    assert cfg.as_dict() == jcfg.as_dict()
    assert DecoderModelConfig.from_dict(json.loads(json.dumps(jcfg.as_dict()))) == cfg
    assert (cfg.feedfwd_dim, cfg.head_dim, cfg.max_seq_len) == (jcfg.feedfwd_dim, jcfg.head_dim,
                                                                 jcfg.max_seq_len)


def test_bridge_round_trip_bit_exact(ft0):
    ck, _, _ = ft0
    model = decoder_from_numpy(ck["model_config"], ck["params"])
    back = decoder_to_numpy(model)
    from novic_tpu_torch.utils.misc import flatten_dict

    src = flatten_dict(ck["params"])
    out = flatten_dict(back)
    assert set(src) == set(out)
    for k in src:
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], src[k].astype(np.float32))
    again = decoder_to_numpy(decoder_from_numpy(ck["model_config"], back))
    for k, v in flatten_dict(again).items():
        np.testing.assert_array_equal(v, out[k])


def test_prefill_and_lazy_steps_match_jax(ft0):
    ck, jcfg, jparams = ft0
    cfg = ck["model_config"]
    model = decoder_from_numpy(cfg, ck["params"])
    jmodel = JDecoder(cfg=jcfg).bind({"params": jparams})
    rng = np.random.default_rng(0)
    Bb, R = 2, 3
    embed = rng.normal(size=(Bb, cfg.embed_dim)).astype(np.float32)

    jl, jpk, jpv = jmodel.prefill_split(jnp.asarray(embed))
    with torch.no_grad():
        l, pk, pv = model.prefill_split(torch.from_numpy(embed))
    _close(l.numpy(), jl)
    for a, b in zip(pk + pv, jpk + jpv):
        _close(a.numpy(), b)

    G = cfg.token_length - 1
    jtk, jtv = jmodel.init_token_cache(Bb * R)
    tk, tv = model.init_token_cache(Bb * R)
    anc = np.full((Bb, R, G), -1, np.int32)
    for step in range(1, 4):
        tok = rng.integers(1, cfg.vocab_size, size=(Bb * R,)).astype(np.int32)
        cand = rng.integers(0, R, size=(Bb, R))
        anc = np.take_along_axis(anc, cand[:, :, None], axis=1)
        anc[:, :, step - 1] = np.arange(R)[None, :]
        allowed = anc[:, :, None, :] == np.arange(R)[None, None, :, None]
        bias = np.where(allowed.reshape(Bb, R, 1, R * G), 0.0, NEG_INF).astype(np.float32)
        jl, jtk, jtv = jmodel.decode_step_lazy(jnp.asarray(tok), step, jpk, jpv, jtk, jtv,
                                               jnp.asarray(bias))
        with torch.no_grad():
            l, tk, tv = model.decode_step_lazy(torch.from_numpy(tok).long(), step, pk, pv,
                                               tk, tv, torch.from_numpy(bias))
        _close(l.numpy(), jl)
        for a, b in zip(tk + tv, jtk + jtv):
            _close(a.numpy(), b)


def test_random_config_matches_jax():
    """A small decoder with biases, post-LN, ReZero and a hidden MLP layer,
    initialised by JAX: prefill logits and the full-sequence forward agree."""
    kw = dict(embed_dim=24, vocab_size=50, token_length=5, hidden_dim=32, num_layers=2,
              num_heads=4, layer_bias=True, logits_bias=True, layer_norm_first=False,
              init_rezero_mode="perskip", init_bias_zero=False, mlp_hidden_layer="min",
              mlp_hidden_bias=True, mlp_hidden_norm=True, weight_tying=False,
              matmul_precision="highest")
    jmodel = JDecoder(cfg=JConfig(**kw))
    embed = np.random.default_rng(1).normal(size=(3, 24)).astype(np.float32)
    params = jmodel.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(embed),
                         jnp.zeros((3, 5), jnp.int32))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1, params)  # non-zero ReZero scales
    bound = jmodel.bind({"params": params})
    jl, _, _ = bound.prefill_split(jnp.asarray(embed))
    model = decoder_from_numpy(DecoderModelConfig(**kw), params)
    with torch.no_grad():
        l, _, _ = model.prefill_split(torch.from_numpy(embed))
    _close(l.numpy(), jl)
    # Full-sequence transformer forward (the layers' __call__ form)
    x = np.random.default_rng(3).normal(size=(3, 8, 32)).astype(np.float32)
    bias = np.array(bound.causality_bias)
    ref = np.asarray(bound.transformer(jnp.asarray(x), jnp.asarray(bias)))
    with torch.no_grad():
        out = model.transformer(torch.from_numpy(x), torch.from_numpy(bias))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("variant", [
    dict(layer_norm_first=True, init_rezero_mode="none"),
    dict(layer_norm_first=False, init_rezero_mode="perskip", layer_bias=True),
    dict(layer_norm_first=False, init_rezero_mode="perlayer"),
], ids=["pre_ln", "post_ln_rezero_perskip", "post_ln_rezero_perlayer"])
def test_step_and_step_split_match_jax(variant):
    """The monolithic-cache step (greedy) and the split-cache step (reorder-mode
    beam), three steps each from the prefill, against JAX: logits and every cache
    within 1e-5 relative."""
    kw = dict(embed_dim=24, vocab_size=50, token_length=6, hidden_dim=32, num_layers=2,
              num_heads=4, mlp_seq_len=3, matmul_precision="highest", **variant)
    jmodel = JDecoder(cfg=JConfig(**kw))
    rng = np.random.default_rng(4)
    Bb, R = 2, 3
    embed = rng.normal(size=(Bb, 24)).astype(np.float32)
    params = jmodel.init({"params": jax.random.PRNGKey(5)}, jnp.asarray(embed),
                         jnp.zeros((Bb, 6), jnp.int32))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1, params)  # non-zero ReZero scales
    bound = jmodel.bind({"params": params})
    model = decoder_from_numpy(DecoderModelConfig(**kw), params)

    # Monolithic caches: prefill, then step
    jk, jv = bound.init_cache(Bb)
    jl, jk, jv = bound.prefill(jnp.asarray(embed), jk, jv)
    with torch.no_grad():
        k, v = model.init_cache(Bb)
        l, k, v = model.prefill(torch.from_numpy(embed), k, v)
    _close(l.numpy(), jl)
    for step in range(1, 4):
        tok = rng.integers(1, 50, size=(Bb,)).astype(np.int32)
        jl, jk, jv = bound.decode_step(jnp.asarray(tok), step, jk, jv)
        with torch.no_grad():
            l, k, v = model.decode_step(torch.from_numpy(tok).long(), step, k, v)
        _close(l.numpy(), jl)
        for a, b in zip(k + v, jk + jv):
            _close(a.numpy(), b)

    # Split caches: prefix at Bb rows, token slots at Bb*R rows
    jl, jpk, jpv = bound.prefill_split(jnp.asarray(embed))
    jtk, jtv = bound.init_token_cache(Bb * R)
    with torch.no_grad():
        l, pk, pv = model.prefill_split(torch.from_numpy(embed))
        tk, tv = model.init_token_cache(Bb * R)
    for step in range(1, 4):
        tok = rng.integers(1, 50, size=(Bb * R,)).astype(np.int32)
        jl, jtk, jtv = bound.decode_step_split(jnp.asarray(tok), step, jpk, jpv, jtk, jtv)
        with torch.no_grad():
            l, tk, tv = model.decode_step_split(torch.from_numpy(tok).long(), step, pk, pv, tk, tv)
        _close(l.numpy(), jl)
        for a, b in zip(tk + tv, jtk + jtv):
            _close(a.numpy(), b)
