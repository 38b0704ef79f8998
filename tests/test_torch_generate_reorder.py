"""Port beam search in cache_mode="reorder" against the JAX package.

The small decoder of tests/test_decoder.py (JAX-initialised, copied through the
bridge) over that file's reorder-vs-lazy kwarg list, vocab cases included: the
port's reorder mode against JAX's reorder mode, tokens and paddings identical,
scores within 1e-5; the port's lazy mode equal to its reorder mode. Vocab
priors on the FT0 decoder are in tests/test_torch_generate_vocab.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from novic_tpu.models.config import DecoderModelConfig as JConfig
from novic_tpu.models.generate import generate_beam as jax_generate_beam
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu_torch.bridge import decoder_from_numpy
from novic_tpu_torch.models import generate
from novic_tpu_torch.models.config import DecoderModelConfig

torch.set_num_threads(2)

# tests/test_decoder.py's model and guide rows
V, CMAX, F = 23, 7, 32
SMALL = dict(embed_dim=F, vocab_size=V, token_length=CMAX, hidden_dim=64, feedfwd_scale="1/4",
             num_layers=2, num_heads=4, input_dropout=0.0, layer_dropout=0.0,
             matmul_precision="highest")


def _small_guides() -> np.ndarray:
    guides = np.zeros((5, CMAX), dtype=np.int32)
    guides[0, :3] = [5, 6, 0]
    guides[1, :4] = [5, 6, 7, 0]
    guides[2, :2] = [9, 0]
    guides[3, :3] = [11, 2, 0]
    guides[4, :3] = [3, 3, 0]
    return guides


@pytest.fixture(scope="module")
def small():
    jmodel = JDecoder(cfg=JConfig(**SMALL))
    embed = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, F)))
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(7)}, embed,
                                  jnp.zeros((2, CMAX), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    e = np.asarray(jax.random.normal(jax.random.PRNGKey(31), (4, F)))
    e = (e / np.linalg.norm(e, axis=-1, keepdims=True)).astype(np.float32)
    return dict(jmodel=jmodel, params=params, embed=e,
                model=decoder_from_numpy(DecoderModelConfig(**SMALL), params))


@pytest.mark.parametrize("kw", [
    dict(topk=4),
    dict(topk=1),
    dict(topk=3, length_alpha=0.7),
    dict(topk=4, temperature=0.7),
    dict(topk=3, guided=True),
    dict(topk=4, guided=True, guide_renorm=True),
    dict(topk=3, vocab=True, vocab_scaler=0.5),
    dict(topk=3, vocab=True, vocab_scaler=0.5, vocab_per_token=True, guided=True),
    dict(topk=4, temperature=0.7, length_alpha=0.3, guided=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_reorder_mode_matches_jax_reorder_mode(small, kw):
    kw = dict(kw)
    guides = _small_guides()
    jkw, pkw = dict(kw), dict(kw)
    for flag, key in (("guided", "guide_targets"), ("vocab", "vocab_targets")):
        if kw.get(flag):
            jkw[key] = jnp.asarray(guides)
            pkw[key] = torch.from_numpy(guides.astype(np.int64))
        jkw.pop(flag, None)
        pkw.pop(flag, None)
    jm = small["jmodel"]
    fn = jax.jit(lambda p, e: jax_generate_beam(jm, p, e, cache_mode="reorder", **jkw))
    jt, jp, js = (np.asarray(x) for x in fn(small["params"], small["embed"]))
    e = torch.from_numpy(small["embed"])
    t, p, s = (x.numpy() for x in generate.generate_beam(small["model"], e, cache_mode="reorder",
                                                         **pkw))
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-5)
    lt, lp, ls = (x.numpy() for x in generate.generate_beam(small["model"], e, cache_mode="lazy",
                                                            **pkw))
    np.testing.assert_array_equal(lt, t)
    np.testing.assert_array_equal(lp, p)
    np.testing.assert_allclose(ls, s, rtol=1e-5, atol=1e-5)


def test_cache_modes_are_checked(small):
    e = torch.from_numpy(small["embed"])
    with pytest.raises(ValueError, match="cache_mode"):
        generate.generate_beam(small["model"], e, topk=2, cache_mode="gather")
    a = generate.generate_beam(small["model"], e, topk=3, cache_mode="auto")
    b = generate.generate_beam(small["model"], e, topk=3, cache_mode="lazy")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
