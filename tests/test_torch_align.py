"""The port's ALIGN towers (novic_tpu_torch.embedders.align) against novic_tpu's
and transformers' on the CPU, narrow and shallow.

* align_block_plan equals novic_tpu's for EfficientNet-B7 (55 blocks) and the
  tiny trunk below.
* A tiny EfficientNet (3 stages: expand ratios 1 and 6, strides 1 and 2,
  kernels 3 and 5, repeated blocks, one block with depthwise_padding) at 64
  px, and BERT at 2 layers with ragged pads, with novic_tpu's params (its
  init plus seeded noise) carried across by bridge: float32 unit embeddings
  within 2e-4 (BERT with exact attention swapped in for K1, whose bf16
  operands alone move embeddings by ~1e-3), bf16 cosine >= 0.9999.
* A tiny transformers.AlignModel built from its config (no hub id) with
  non-trivial BN statistics: its conversion equals novic_tpu's bit for bit,
  and the port's float32 towers are within 2e-4 of get_image_features /
  get_text_features.
* Its saved local HF directory resolves to novic_tpu's arch, converts
  through action=convert_embedder, and serves in TorchEmbedder as in
  JaxEmbedder.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
import transformers

from novic_tpu.embedders import align as jalign
from novic_tpu.embedders import convert as jconvert
from novic_tpu.embedders.base import Embedder as JEmbedder
from novic_tpu.embedders.registry import lookup as jlookup
from novic_tpu_torch.bridge import align_vision_from_numpy, bert_text_from_numpy
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.embedders import align, convert
from novic_tpu_torch.embedders.base import Embedder
from novic_tpu_torch.embedders.registry import lookup
from novic_tpu_torch.utils.misc import flatten_dict, unflatten_dict

torch.set_num_threads(2)
TOL = 2e-4
COSINE_MIN = 0.9999
IMG = 64
TINY_VISION = dict(width_coefficient=0.25, depth_coefficient=1.0, depth_divisor=4,
                   kernel_sizes=(3, 5, 3), in_channels=(32, 48, 64), out_channels=(48, 64, 80),
                   strides=(1, 2, 2), num_block_repeats=(1, 2, 1), expand_ratios=(1, 6, 6),
                   depthwise_padding=(3,))
TINY_TEXT = dict(context_length=10, vocab_size=50, width=32, layers=2, heads=4, mlp_dim=64,
                 max_position_embeddings=24)
PROJ = 20  # round_filters(80) at width 0.25: ALIGN's image embedding is the trunk's


def _exact_attention(q, k, v, bias=None, key_bias=None):
    """K1's function in exact float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def _unit(x):
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _ragged_ids(seed, B=4, S=10, vocab=50):
    """[CLS]=2 first, content ids 4.., [SEP]=3 last, pads (0) after: lengths
    1 (only [CLS]) to S."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, S), np.int32)
    for b, n in enumerate([1, 3, S, 6][:B]):
        ids[b, :n] = rng.integers(4, vocab, size=n)
        ids[b, 0] = 2
        if n > 1:
            ids[b, n - 1] = 3
    return ids


def _jax_params(module, dummy, seed):
    """novic_tpu's init plus seeded noise on every leaf (BN scales and biases too)."""
    params = jax.jit(module.init)({"params": jax.random.PRNGKey(seed)}, dummy)["params"]
    flat = flatten_dict(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    return unflatten_dict({k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
                           for k, v in flat.items()})


@pytest.mark.parametrize("kw", [{}, TINY_VISION], ids=["b7", "tiny"])
def test_block_plan_equals_jax(kw):
    plan = align.align_block_plan(align.AlignVisionConfig(**kw))
    jplan = jalign.align_block_plan(jalign.AlignVisionConfig(**kw))
    assert [dataclasses.asdict(p) for p in plan] == [dataclasses.asdict(p) for p in jplan]
    if not kw:
        assert len(plan) == 55 and sum(p.stride == 2 for p in plan) == 4
        assert plan[-1].out_dim == 640


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_efficientnet_matches_jax(dtype):
    kw = dict(TINY_VISION, image_size=IMG, embed_dim=PROJ, compute_dtype=dtype)
    jcfg, cfg = jalign.AlignVisionConfig(**kw), align.AlignVisionConfig(**kw)
    params = _jax_params(jalign.EfficientNetTower(cfg=jcfg),
                         np.zeros((1, IMG, IMG, 3), np.float32), seed=1)
    images = np.random.default_rng(2).normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jalign.EfficientNetTower(cfg=jcfg).apply)({"params": params},
                                                                      images))
    with torch.no_grad():
        ours = align_vision_from_numpy(cfg, params)(torch.from_numpy(images)).numpy()
    assert ours.shape == ref.shape == (3, PROJ)
    if dtype == "float32":
        assert np.abs(_unit(ours) - _unit(ref)).max() <= TOL
    else:
        assert (_unit(ours) * _unit(ref)).sum(-1).min() >= COSINE_MIN


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_matches_jax(monkeypatch, dtype):
    kw = dict(TINY_TEXT, embed_dim=PROJ, compute_dtype=dtype)
    jcfg, cfg = jalign.AlignTextConfig(**kw), align.AlignTextConfig(**kw)
    ids = _ragged_ids(3)
    params = _jax_params(jalign.BertTextTower(cfg=jcfg), ids, seed=4)
    ref = np.asarray(jax.jit(jalign.BertTextTower(cfg=jcfg).apply)({"params": params}, ids))
    if dtype == "float32":
        monkeypatch.setattr(align, "fused_attention", _exact_attention)
    with torch.no_grad():
        ours = bert_text_from_numpy(cfg, params)(torch.from_numpy(ids)).numpy()
    assert ours.shape == ref.shape == (4, PROJ)
    if dtype == "float32":
        assert np.abs(_unit(ours) - _unit(ref)).max() <= TOL
    else:
        assert (_unit(ours) * _unit(ref)).sum(-1).min() >= COSINE_MIN


def test_bert_pads_are_masked():
    """Changing the embedding of a padded position's id changes nothing: the
    pads are masked out of every query row (K1's key bias)."""
    cfg = align.AlignTextConfig(**TINY_TEXT, embed_dim=PROJ)
    tower = align.BertTextTower(cfg).init_random(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ragged_ids(5))
    with torch.no_grad():
        out = tower(ids)
        # positions past row 3's 6 tokens: pads only there
        tower.pos_embedding[6:] += torch.randn(tower.pos_embedding[6:].shape,
                                               generator=torch.Generator().manual_seed(1))
        out2 = tower(ids)
    assert torch.equal(out[3], out2[3]) and not torch.equal(out[2], out2[2])


# -- transformers' AlignModel ----------------------------------------------------------


def _randomize_bn(model):
    """Non-trivial BN statistics, so the folding is exercised."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.normal_(1.0, 0.2)
                m.bias.normal_(0, 0.2)


@pytest.fixture(scope="module")
def hf_align():
    from transformers.models.align.configuration_align import (
        AlignConfig,
        AlignTextConfig,
        AlignVisionConfig,
    )

    v = {k: list(x) if isinstance(x, tuple) else x for k, x in TINY_VISION.items()}
    vision_cfg = AlignVisionConfig(image_size=IMG, hidden_dim=64, **v)
    text_cfg = AlignTextConfig(vocab_size=50, hidden_size=32, num_hidden_layers=2,
                               num_attention_heads=4, intermediate_size=64,
                               max_position_embeddings=24, pad_token_id=0)
    cfg = AlignConfig(text_config=text_cfg.to_dict(), vision_config=vision_cfg.to_dict(),
                      projection_dim=PROJ)
    torch.manual_seed(0)
    model = transformers.AlignModel(cfg).eval()
    _randomize_bn(model)
    return model


def test_conversion_equals_jax(hf_align):
    v, t = convert.convert_hf_model(hf_align, "align")
    jv, jt = jconvert.convert_hf_model(hf_align, "align")
    for a, b in ((v, jv), (t, jt)):
        fa, fb = flatten_dict(a), flatten_dict(b)
        assert list(fa) == list(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    cfg = convert.align_cfg_from_hf(hf_align.config.vision_config)
    jcfg = jconvert.align_cfg_from_hf(hf_align.config.vision_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.embed_dim == PROJ


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_towers_match_transformers(hf_align, monkeypatch, tower):
    v, t = convert.convert_hf_model(hf_align, "align")
    with torch.no_grad():
        if tower == "vision":
            cfg = dataclasses.replace(convert.align_cfg_from_hf(hf_align.config.vision_config),
                                      image_size=IMG, compute_dtype="float32")
            imgs = np.random.default_rng(6).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
            ref = hf_align.get_image_features(pixel_values=torch.from_numpy(
                imgs.transpose(0, 3, 1, 2)))
            out = align_vision_from_numpy(cfg, v)(torch.from_numpy(imgs))
        else:
            monkeypatch.setattr(align, "fused_attention", _exact_attention)
            cfg = align.AlignTextConfig(**TINY_TEXT, embed_dim=PROJ, compute_dtype="float32")
            ids = _ragged_ids(7)
            ref = hf_align.get_text_features(input_ids=torch.from_numpy(ids).long(),
                                             attention_mask=torch.from_numpy(ids != 0).long())
            out = bert_text_from_numpy(cfg, t)(torch.from_numpy(ids))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def _local_dir(hf_align, tmp_path):
    d = tmp_path / "align_ckpt"
    hf_align.save_pretrained(d)
    (d / "preprocessor_config.json").write_text(json.dumps({
        "size": {"height": 72, "width": 72}, "do_center_crop": True,
        "crop_size": {"height": IMG, "width": IMG}, "resample": 0,
        "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}))
    return d


def test_local_dir_converts_and_serves_as_jax(hf_align, tmp_path):
    d = _local_dir(hf_align, tmp_path)
    spec = f"transformers:{d}"
    arch, jarch = lookup(spec), jlookup(spec)
    for part in ("vision", "text", "preprocess"):
        assert dataclasses.asdict(getattr(arch, part)) == dataclasses.asdict(getattr(jarch, part))
    assert (arch.family, arch.tokenizer, arch.preprocess.size) == ("align", "bert", IMG)
    out = str(tmp_path / "align.npz")
    main(["action=convert_embedder", f"embedder={spec}", f"embedder_weights={out}",
          "--device=cpu"])
    ref = str(tmp_path / "jax.npz")
    jconvert.save_params_npz(ref, *jconvert.convert_hf_model(hf_align, "align"))
    with np.load(out) as a, np.load(ref) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    kw = dict(weights_path=out, inference_batch_size=4, image_batch_size=4)
    pemb = Embedder.create(spec, device="cpu", **kw)
    jemb = JEmbedder.create(spec, **kw)
    assert pemb.configuration == jemb.configuration
    frames = list(np.random.default_rng(8).integers(0, 256, size=(3, 80, 80, 3), dtype=np.uint8))
    pix = pemb.get_image_transform()(frames)
    np.testing.assert_array_equal(pix.numpy(), jemb.get_image_transform()(frames))
    cos = (_unit(pemb.inference_image(pix)) * _unit(jemb.inference_image(pix.numpy()))).sum(-1)
    assert cos.min() >= COSINE_MIN
    texts = ["a photo of a cat", "dog", "a red fire truck in the street"]
    cos = (_unit(pemb.inference_text(texts)) * _unit(jemb.inference_text(texts))).sum(-1)
    assert cos.min() >= COSINE_MIN


def test_convert_embedder_refuses_an_open_clip_state_dict_for_align(hf_align, tmp_path):
    d = _local_dir(hf_align, tmp_path)
    with pytest.raises(ValueError, match="AlignModel"):
        main(["action=convert_embedder", f"embedder=transformers:{d}",
              f"load_model={tmp_path}/x.bin", f"embedder_weights={tmp_path}/x.npz",
              "--device=cpu"])
