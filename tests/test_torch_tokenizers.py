"""The port's real tokenizers (novic_tpu_torch.text.clip_bpe, .sentencepiece,
.wordpiece) and TorchEmbedder's tokenizer choice against novic_tpu's.

Vocabulary files are synthetic, built as tests/test_clip_bpe.py,
test_sentencepiece.py and test_wordpiece.py build them (no downloads). Both
packages give the same token ids and metadata; `_build_tokenizer` picks the
same tokenizer for each `arch.tokenizer` from `bpe_merges_path` or the
environment ($NOVIC_CLIP_BPE, $NOVIC_SIGLIP_SPM, $NOVIC_BERT_VOCAB), and the
word-level test tokenizer when no file is named. A small CLIP-shaped
TorchEmbedder with $NOVIC_CLIP_BPE set embeds texts as the JaxEmbedder does
on the same weights: within 2e-4 at float32 compute (the same ids, the JAX
text tower through its Pallas attention as the port's through its kernel;
sums in another order).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import novic_tpu.ops.attention as jax_attention
from novic_tpu.embedders import vit as jvit
from novic_tpu.embedders.base import JaxEmbedder
from novic_tpu.embedders.convert import save_params_npz
from novic_tpu.embedders.registry import REGISTRY as JREGISTRY
from novic_tpu.text import clip_bpe as jclip
from novic_tpu.text import sentencepiece as jspm
from novic_tpu.text import wordpiece as jwp
from novic_tpu_torch.embedders.base import Embedder, TorchEmbedder
from novic_tpu_torch.embedders.registry import REGISTRY
from novic_tpu_torch.text import clip_bpe, sentencepiece, wordpiece

torch.set_num_threads(2)

MERGES = ["o g</w>", "d og</w>", "a t</w>", "c at</w>", "r e", "e e</w>", "t re", "tre e</w>"]
CLIP_TEXTS = ["a dog", "tree dog!", "cat", "catdog tree", "DOG cat", "  spaced   out  ", "og re",
              "café &amp; dög 42", "it's  tree dog", "你好"]
SPM_PIECES = [("<pad>", 0.0, jspm.CONTROL), ("<unk>", 0.0, jspm.UNKNOWN),
              ("</s>", 0.0, jspm.CONTROL), ("▁a", -2.0, jspm.NORMAL),
              ("▁ab", -1.0, jspm.NORMAL), ("▁abc", -5.0, jspm.NORMAL),
              ("b", -2.5, jspm.NORMAL), ("c", -1.0, jspm.NORMAL), ("▁", -3.0, jspm.NORMAL),
              ("d", -2.0, jspm.NORMAL)]
SPM_TEXTS = ["Ab!", "abc abc", "a b c d", "dab, cab.", "xyz", "  A  bc "]
WP_TOKENS = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + ["a", "an", "the", "photo", "of", "dog", "cat", "fire", "truck", "un", "##aff",
                "##able", "##s", "##ing", "run", "!", ",", ".", "do", "##g", "##gy", "12", "##3"])
WP_TEXTS = ["a photo of a dog", "A PHOTO OF A CAT", "fire truck!", "doggy, 123",
            "unaffable running", "café dog", "你好 dog", "dog" * 40]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    be = jclip.bytes_to_unicode()
    vocab = list(be.values())
    vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m.split()) for m in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps({v: i for i, v in enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    (d / "spm.model").write_bytes(jspm.build_model_proto(SPM_PIECES, unk_id=1, eos_id=2, pad_id=0))
    (d / "vocab.txt").write_text("\n".join(WP_TOKENS) + "\n")
    return {"clip_bpe": str(d / "merges.txt"), "sentencepiece": str(d / "spm.model"),
            "bert": str(d / "vocab.txt"), "wordpiece": str(d / "vocab.txt")}


META = ("context_length", "vocab_size", "cased", "start_token_id", "end_token_id", "pad_token_id")


def _same(port_tok, jax_tok, texts):
    for attr in META:
        assert getattr(port_tok, attr) == getattr(jax_tok, attr), attr
    a = port_tok.tokenize(texts, output_dict=True)
    b = jax_tok.tokenize(texts, output_dict=True)
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    assert port_tok.detokenize(a["input_ids"]) == jax_tok.detokenize(b["input_ids"])


@pytest.mark.parametrize("context", [8, 77])
def test_clip_bpe_ids_match_jax(files, context):
    port_tok = clip_bpe.CLIPBPETokenizer(files["clip_bpe"], context_length=context)
    _same(port_tok, jclip.CLIPBPETokenizer(files["clip_bpe"], context_length=context), CLIP_TEXTS)
    assert port_tok.encode("tree dog") == [512 + 7, 512 + 1]  # the merges "tree</w>", "dog</w>"


@pytest.mark.parametrize("prefer_native", [True, False])
def test_sentencepiece_ids_match_jax(files, prefer_native):
    data = open(files["sentencepiece"], "rb").read()
    _same(sentencepiece.SentencePieceTokenizer(data, context_length=8, prefer_native=prefer_native),
          jspm.SentencePieceTokenizer(data, context_length=8, prefer_native=prefer_native), SPM_TEXTS)
    a, b = sentencepiece.parse_model_proto(data), jspm.parse_model_proto(data)
    assert a.pieces == b.pieces and np.array_equal(a.scores, b.scores)


@pytest.mark.parametrize("keep_sep", [True, False])
def test_wordpiece_ids_match_jax(files, keep_sep):
    _same(wordpiece.BertWordPieceTokenizer(files["bert"], context_length=16, keep_sep=keep_sep),
          jwp.BertWordPieceTokenizer(files["bert"], context_length=16, keep_sep=keep_sep), WP_TEXTS)


ENV = {"clip_bpe": "NOVIC_CLIP_BPE", "sentencepiece": "NOVIC_SIGLIP_SPM", "bert": "NOVIC_BERT_VOCAB",
       "wordpiece": "NOVIC_BERT_VOCAB"}
TEXTS = {"clip_bpe": CLIP_TEXTS, "sentencepiece": SPM_TEXTS, "bert": WP_TEXTS, "wordpiece": WP_TEXTS}


@pytest.mark.parametrize("source", ["none", "env", "argument", "missing_file"])
@pytest.mark.parametrize("kind", list(ENV))
def test_build_tokenizer_choice_matches_jax(files, monkeypatch, kind, source):
    for var in set(ENV.values()):
        monkeypatch.delenv(var, raising=False)
    path = None
    if source == "env":
        monkeypatch.setenv(ENV[kind], files[kind])
    elif source == "argument":
        path = files[kind]
    elif source == "missing_file":
        path = files[kind] + ".absent"
    spec = "openclip:timm/ViT-B-16-SigLIP"
    arch = dataclasses.replace(REGISTRY[spec], tokenizer=kind)
    jarch = dataclasses.replace(JREGISTRY[spec], tokenizer=kind)
    port_tok = TorchEmbedder._build_tokenizer(arch, path)
    jax_tok = JaxEmbedder._build_tokenizer(jarch, path)
    assert type(port_tok).__name__ == type(jax_tok).__name__
    want = {"clip_bpe": "CLIPBPETokenizer", "sentencepiece": "SentencePieceTokenizer",
            "bert": "BertWordPieceTokenizer", "wordpiece": "BertWordPieceTokenizer"}[kind]
    assert type(port_tok).__name__ == (want if source in ("env", "argument") else "SimpleWordTokenizer")
    _same(port_tok, jax_tok, TEXTS[kind])


def test_embedder_create_threads_bpe_merges_path(files, monkeypatch):
    monkeypatch.delenv("NOVIC_CLIP_BPE", raising=False)
    emb = Embedder.create("openai:ViT-B/16", bpe_merges_path=files["clip_bpe"], load_model=False,
                          device="cpu")
    assert isinstance(emb.tokenizer, clip_bpe.CLIPBPETokenizer)
    # The configuration hash names no tokenizer, as JAX's: caches stay byte-identical
    jemb = JaxEmbedder(spec="openai:ViT-B/16", arch=JREGISTRY["openai:ViT-B/16"],
                       tokenizer_batch_size=8, inference_batch_size=8, image_batch_size=8,
                       load_model=False, check=False, weights_path=None,
                       bpe_merges_path=files["clip_bpe"], tokenizer=None,
                       compute_dtype="bfloat16", seed=0)
    assert emb.get_configuration_hash(True, False) == jemb.get_configuration_hash(True, False)
    assert emb.get_configuration_hash(True, False) == Embedder.create(
        "openai:ViT-B/16", load_model=False, device="cpu").get_configuration_hash(True, False)


def _small(arch, vocab):
    return dataclasses.replace(
        arch, vision=dataclasses.replace(arch.vision, patch_size=32, width=64, layers=1, heads=4),
        text=dataclasses.replace(arch.text, width=64, layers=2, heads=4, vocab_size=vocab,
                                 context_length=12))


def test_torch_embedder_with_clip_bpe_matches_jax_embedder(files, monkeypatch):
    attn = jax_attention.fused_attention
    monkeypatch.setattr(jax_attention, "fused_attention",
                        lambda q, k, v, bias=None, **kw: attn(q, k, v, bias, interpret=True))
    monkeypatch.setenv("NOVIC_CLIP_BPE", files["clip_bpe"])
    spec = "openai:ViT-B/16"
    vocab = jclip.CLIPBPETokenizer(files["clip_bpe"]).vocab_size
    # The JAX tower through its Pallas attention (interpreted), which rounds P
    # to bf16 as the port's attention kernel does at every compute dtype
    jarch = _small(JREGISTRY[spec], vocab)
    jarch = dataclasses.replace(jarch, text=dataclasses.replace(jarch.text,
                                                               use_pallas_attention=True))
    kv, kt = jax.random.split(jax.random.PRNGKey(6))
    vparams = jvit.VisionTransformer(cfg=jarch.vision).init(
        {"params": kv}, jnp.zeros((1, jarch.vision.image_size, jarch.vision.image_size, 3)))["params"]
    tparams = jvit.TextTransformer(cfg=jarch.text).init(
        {"params": kt}, jnp.zeros((1, 12), jnp.int32))["params"]
    weights = os.path.join(os.path.dirname(files["clip_bpe"]), "small_clip.npz")
    save_params_npz(weights, jax.tree.map(np.asarray, vparams), jax.tree.map(np.asarray, tparams))
    common = dict(spec=spec, load_model=True, check=False, weights_path=weights,
                  compute_dtype="float32", seed=0, inference_batch_size=8,
                  tokenizer_batch_size=8, image_batch_size=4, tokenizer=None)
    jemb = JaxEmbedder(arch=jarch, bpe_merges_path=None, **common)
    temb = TorchEmbedder(arch=_small(REGISTRY[spec], vocab), device="cpu", **common)
    assert isinstance(temb.tokenizer, clip_bpe.CLIPBPETokenizer)
    texts = CLIP_TEXTS[:8]
    np.testing.assert_array_equal(temb.tokenize(texts), jemb.tokenize(texts))
    ref, out = jemb.inference_text(texts), temb.inference_text(texts)
    assert out.shape == ref.shape == (8, jarch.vision.embed_dim)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
