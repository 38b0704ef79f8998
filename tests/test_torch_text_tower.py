"""Port text tower and the text half of the embedder against the JAX package.

Small CLIP-like (causal, `argmax` pool) and SigLIP-like (bidirectional, `last`
pool, projection bias) TextTransformers are initialised by JAX and carried over
by bridge.py; the JAX side runs its Pallas attention (and, with `quant`, its
Pallas int8 GEMM) interpreted on the CPU. Bars: 5e-3 elementwise at float32
compute (the bar of tests/test_torch_vit.py); embedding cosine >= 0.9999 at
bf16 compute. The int8 towers' quantizers and GEMMs equal the JAX package's
bit for bit (tests/test_torch_int8.py), so at float32 compute they keep the
5e-3 bar. At bf16 compute they keep INT8_BF16_COSINE instead: the two
frameworks sum in other orders, so a bf16 activation can land one ulp apart,
and one bf16 ulp near a row's maximum is about half an int8 step (127 * 2^-8);
where the row maximum itself moves, every code of the row shifts. Over three
seeds at width 64 this gave cosines of 0.99982-0.99993, where the unquantized
towers give >= 0.99996.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import novic_tpu.ops.attention as jax_attention
import novic_tpu.ops.int8_matmul as jint8
from novic_tpu.embedders import vit as jvit
from novic_tpu.embedders.base import JaxEmbedder
from novic_tpu.embedders.convert import save_params_npz
from novic_tpu.embedders.registry import REGISTRY as JREGISTRY
from novic_tpu.text.simple import make_test_tokenizer as jax_make_test_tokenizer
from novic_tpu_torch.bridge import text_tower_from_numpy
from novic_tpu_torch.embedders import vit
from novic_tpu_torch.embedders.base import TorchEmbedder, tower_modules
from novic_tpu_torch.embedders.registry import REGISTRY
from novic_tpu_torch.text.simple import make_test_tokenizer

torch.set_num_threads(2)

INT8_BF16_COSINE = 0.9995

CLIP = dict(context_length=16, vocab_size=50, width=64, layers=2, heads=4, embed_dim=48,
            act="quick_gelu", causal=True, pool="argmax", proj_bias=False)
SIGLIP = dict(context_length=16, vocab_size=50, width=64, layers=2, heads=4, embed_dim=64,
              act="gelu_tanh", causal=False, pool="last", proj_bias=True, layer_norm_eps=1e-6)


@pytest.fixture
def interpreted_pallas(monkeypatch):
    attn = jax_attention.fused_attention
    monkeypatch.setattr(jax_attention, "fused_attention",
                        lambda q, k, v, bias=None, **kw: attn(q, k, v, bias, interpret=True))
    mm = jint8.int8_matmul_pallas
    monkeypatch.setattr(jint8, "int8_matmul_pallas",
                        lambda xq, wq_t, **kw: mm(xq, wq_t, **{**kw, "interpret": True}))


def _tokens(n, cfg, seed):
    """Random ids below the top id, with a top id (the end token) in each row;
    row 0 holds it twice, so `argmax` pooling must take the first."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg["vocab_size"] - 1, size=(n, cfg["context_length"])).astype(np.int32)
    for i in range(n):
        ids[i, rng.integers(1, cfg["context_length"])] = cfg["vocab_size"] - 1
    ids[0, 2] = ids[0, 9] = cfg["vocab_size"] - 1
    return ids


def _jax_tower(cfg_kwargs, ids, seed=0):
    cfg = jvit.TextTowerConfig(**cfg_kwargs, use_pallas_attention=True)
    model = jvit.TextTransformer(cfg=cfg)
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(ids[:1]))["params"]
    out = np.asarray(jax.jit(lambda p, x: model.apply({"params": p}, x))(params, jnp.asarray(ids)))
    return jax.tree.map(np.asarray, params), out


def _port(cfg_kwargs, params, ids):
    model = text_tower_from_numpy(vit.TextTowerConfig(**cfg_kwargs), params)
    with torch.no_grad():
        return model(torch.from_numpy(ids)).numpy()


def _cos(a, b):
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.mark.parametrize("name,quant", [("clip", ""), ("siglip", ""), ("clip", "int8"),
                                        ("siglip", "int8:pallas")])
def test_text_tower_float32_matches_jax(interpreted_pallas, name, quant):
    kwargs = {**(CLIP if name == "clip" else SIGLIP), "compute_dtype": "float32", "quant": quant}
    ids = _tokens(3, kwargs, 1)
    params, ref = _jax_tower(kwargs, ids)
    out = _port(kwargs, params, ids)
    assert out.shape == ref.shape == (3, kwargs["embed_dim"])
    np.testing.assert_allclose(out, ref, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("name,quant", [("clip", ""), ("siglip", ""), ("clip", "int8:pallas"),
                                        ("siglip", "int8")])
def test_text_tower_bfloat16_cosine(interpreted_pallas, name, quant):
    kwargs = {**(CLIP if name == "clip" else SIGLIP), "compute_dtype": "bfloat16", "quant": quant}
    ids = _tokens(4, kwargs, 2)
    params, ref = _jax_tower(kwargs, ids, seed=1)
    out = _port(kwargs, params, ids)
    assert _cos(out, ref).min() >= (INT8_BF16_COSINE if quant else 0.9999), _cos(out, ref)


def test_int8_text_tower_is_not_the_unquantized_tower(interpreted_pallas):
    kwargs = {**CLIP, "compute_dtype": "float32"}
    ids = _tokens(3, kwargs, 3)
    params, _ = _jax_tower(kwargs, ids)
    _, ref_q = _jax_tower({**kwargs, "quant": "int8"}, ids)
    plain = _port(kwargs, params, ids)
    quant = _port({**kwargs, "quant": "int8"}, params, ids)
    np.testing.assert_allclose(quant, ref_q, atol=5e-3, rtol=5e-3)
    assert np.abs(quant - plain).max() > 10 * np.abs(quant - ref_q).max()


def test_causal_mask_and_argmax_pool():
    """Causal: the pooled token sees nothing after it. argmax: the first end token."""
    cfg = vit.TextTowerConfig(**CLIP, compute_dtype="float32")
    model = vit.TextTransformer(cfg).init_random(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_tokens(2, CLIP, 4)).long()
    first_end = int(ids[0].argmax())
    assert first_end == 2
    later = ids.clone()
    later[0, first_end + 1:] = 7  # tokens after the pooled one (ids below the end id)
    with torch.no_grad():
        a, b = model(ids), model(later)
    torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=1e-6)


def test_text_random_init_matches_flax_scales():
    cfg = vit.TextTowerConfig(**SIGLIP)
    model = vit.TextTransformer(cfg).init_random(torch.Generator().manual_seed(0))
    again = vit.TextTransformer(cfg).init_random(torch.Generator().manual_seed(0))
    jparams = jax.jit(jvit.TextTransformer(cfg=jvit.TextTowerConfig(**SIGLIP)).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16), jnp.int32))["params"]
    from novic_tpu.utils.misc import flatten_dict

    jflat = {k: np.asarray(v) for k, v in flatten_dict(jparams).items()}
    state = model.state_dict()
    assert set(state) == set(jflat)
    for name, value in state.items():
        ref = jflat[name]
        assert tuple(value.shape) == ref.shape, name
        assert torch.equal(value, again.state_dict()[name]), name
        if ref.size >= 256:
            assert abs(float(value.std()) - float(ref.std())) <= 0.15 * float(ref.std()) + 1e-6, name
        else:
            assert abs(float(value.mean()) - float(ref.mean())) <= 0.5 * float(ref.std()) + 1e-6, name
    assert abs(float(state["token_embedding"].std()) - 0.02) < 0.002
    assert abs(float(state["pos_embedding"].std()) - 0.01) < 0.002


def test_tower_modules_dispatch():
    from novic_tpu_torch.embedders import align, eva

    arch = REGISTRY["openai:ViT-B/16"]
    vision, text = tower_modules(arch)
    assert isinstance(vision, vit.VisionTransformer) and isinstance(text, vit.TextTransformer)
    # eva02: the EVA02 vision tower beside the CLIP text tower; align: both its own
    eva_arch = REGISTRY["openclip:timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k"]
    vision, text = tower_modules(eva_arch)
    assert isinstance(vision, eva.EvaVisionTransformer) and isinstance(text, vit.TextTransformer)
    with torch.device("meta"):
        vision, text = tower_modules(REGISTRY["transformers:kakaobrain/align-base"])
    assert isinstance(vision, align.EfficientNetTower) and isinstance(text, align.BertTextTower)


# -- the embedder's text side --------------------------------------------------

SPEC = "openclip:timm/ViT-B-16-SigLIP"
WORDS = ["dog", "traffic light", "a cat on a mat", "zebra"]


def _small(arch, quant=""):
    return dataclasses.replace(
        arch, vision=dataclasses.replace(arch.vision, patch_size=32, width=64, layers=1, heads=4,
                                         quant=quant),
        text=dataclasses.replace(arch.text, width=64, layers=2, heads=4, vocab_size=64,
                                 context_length=12, quant=quant))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jarch = _small(JREGISTRY[SPEC])
    kv, kt = jax.random.split(jax.random.PRNGKey(5))
    vparams = jvit.VisionTransformer(cfg=jarch.vision).init({"params": kv},
                                                             jnp.zeros((1, 224, 224, 3)))["params"]
    tparams = jvit.TextTransformer(cfg=jarch.text).init(
        {"params": kt}, jnp.zeros((1, jarch.text.context_length), jnp.int32))["params"]
    path = str(tmp_path_factory.mktemp("weights") / "small_siglip.npz")
    save_params_npz(path, jax.tree.map(np.asarray, vparams), jax.tree.map(np.asarray, tparams))
    return path


def _embedders(weights, quant, batch):
    common = dict(spec=SPEC, load_model=True, check=False, weights_path=weights,
                  compute_dtype="float32", seed=0, inference_batch_size=batch,
                  tokenizer_batch_size=8, image_batch_size=4)
    jemb = JaxEmbedder(arch=_small(JREGISTRY[SPEC], quant), bpe_merges_path=None,
                       tokenizer=jax_make_test_tokenizer(WORDS, context_length=12), **common)
    temb = TorchEmbedder(arch=_small(REGISTRY[SPEC], quant), device="cpu",
                         tokenizer=make_test_tokenizer(WORDS, context_length=12), **common)
    return jemb, temb


@pytest.mark.parametrize("quant", ["", "int8"])
def test_torch_embedder_text_matches_jax_embedder(interpreted_pallas, weights, quant):
    jemb, temb = _embedders(weights, quant, batch=8)
    assert temb.get_configuration_hash(True, False) == jemb.get_configuration_hash(True, False)
    assert temb.configuration["text"]["quant"] == temb.configuration["vision"]["quant"] == quant
    for attr in ("context_length", "vocab_size", "cased_tokens", "start_token_id",
                 "end_token_id", "pad_token_id", "token_dtype"):
        assert getattr(temb, attr) == getattr(jemb, attr), attr
    np.testing.assert_array_equal(temb.tokenize(WORDS), jemb.tokenize(WORDS))
    assert temb.get_tokenize_details(WORDS, token_id_set=True) == \
        jemb.get_tokenize_details(WORDS, token_id_set=True)
    ref = jemb.inference_text(WORDS)
    out = temb.inference_text(WORDS)
    assert out.dtype == np.float32 and out.shape == ref.shape == (4, 768)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(out, ref, atol=5e-3, rtol=5e-3)
    # Short sequences are padded to the context length with the pad id
    ids = temb.tokenize(WORDS[:2])
    assert ids.shape[1] < temb.context_length
    np.testing.assert_array_equal(temb.inference_tokens({"input_ids": ids}), out[:2])


def test_inference_tokens_pads_the_batch_and_the_context(weights):
    """Each text's embedding does not depend on the batch padding, and too long
    sequences raise as in the JAX embedder."""
    _, temb = _embedders(weights, "", batch=6)
    many = temb.inference_text(WORDS)
    one = temb.inference_text(WORDS[2])
    np.testing.assert_allclose(one[0], many[2], atol=1e-6)
    with pytest.raises(ValueError, match="longer than context length"):
        temb.inference_tokens({"input_ids": np.zeros((1, 13), np.int32)})
    with temb.inference_mode():
        assert torch.is_inference_mode_enabled()
    temb.unload_model()
    with temb.inference_model():
        assert temb.is_model_loaded()
    assert not temb.is_model_loaded()
