"""The port's data- and tensor-parallel paths (parallel/mesh.py, parallel/tp.py,
TorchEmbedder.set_mesh, NOVICModel.set_mesh, the data-parallel train step)
against one process and against novic_tpu, on the CPU.

Ranks are spawned processes on gloo over a file:// store (tests/
torch_dist_workers.py), each joined within 120 s. Bars:
  * a 2-rank DP train step equals one process's step on the global batch and
    novic_tpu's single-device step (dropout and noise off there, as its masks
    are other draws) at test_train.py's DP bars: loss rtol 1e-6, grad_norm
    rtol 1e-5, params atol 1e-5; with dropout, noise and accumulation on it
    equals one process's step with the same seeds;
  * 2-rank DP classify_embeds: the preds of one process and of novic_tpu,
    logprobs rtol 1e-4 / atol 1e-5, and the "not divisible" refusal;
  * TP=2 towers (cls, map and avg pools; EVA02 with SwiGLU and with fused
    qkv) and a 4-rank 2x2 dp_tp mesh: one process's and novic_tpu's
    embeddings within atol 2e-5 (test_tp.py's bar), float32 with exact
    attention on the port's side (novic_tpu's XLA attention is exact float32;
    K1 rounds its operands to bf16);
  * tp_param_spec gives novic_tpu's layout for every parameter of every
    registered tower family.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from novic_tpu.embedders import eva as jeva
from novic_tpu.embedders import vit as jvit
from novic_tpu.embedders.base import Embedder as JEmbedder
from novic_tpu.embedders.convert import save_params_npz
from novic_tpu.embedders.registry import EmbedderArch as JArch
from novic_tpu.infer import NOVICModel as JNOVICModel
from novic_tpu.models.base import create_decoder as j_create_decoder
from novic_tpu.models.config import DecoderModelConfig as JConfig
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.parallel import tp as jtp
from novic_tpu.train.optim import create_optimizer as j_create_optimizer
from novic_tpu.train.step import create_train_state, make_train_step as j_make_train_step
from novic_tpu.utils.misc import flatten_dict
from novic_tpu_torch.embedders import eva as peva
from novic_tpu_torch.embedders import vit as pvit
from novic_tpu_torch.embedders.base import tower_modules
from novic_tpu_torch.embedders.preprocess import PreprocessConfig
from novic_tpu_torch.embedders.registry import REGISTRY, EmbedderArch
from novic_tpu_torch.parallel import tp as ptp
from torch_dist_workers import run_ranks

torch.set_num_threads(2)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-6, 1e-5, 1e-5   # test_train.py:318-324
TP_ATOL = 2e-5                                        # test_tp.py:74
F, V, C, B = 24, 40, 5, 8
BASE = dict(embed_dim=F, vocab_size=V, token_length=C, hidden_dim=32, num_layers=2, num_heads=4,
            mlp_seq_len=3, input_dropout=0.0, layer_dropout=0.0, matmul_precision="highest")


# ---------------------------------------------------------------------------
# Data-parallel training
# ---------------------------------------------------------------------------


def _decoder_params(**kw):
    _, params = j_create_decoder(JConfig(**{**BASE, **kw}), rng=jax.random.PRNGKey(1))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _loader_batch(rng, rows=B):
    embed = rng.normal(size=(rows, F)).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    lengths = rng.integers(1, C + 1, size=rows)
    pad = np.arange(C) >= lengths[:, None]  # ragged: the ranks' token counts differ
    tok = np.where(pad, 0, rng.integers(1, V, size=(rows, C))).astype(np.int32)
    return embed, tok, pad, None


def _jax_step(params, batch, lr, clip):
    jmodel = JDecoder(cfg=JConfig(**BASE))
    tx = j_create_optimizer()
    state = create_train_state(jax.tree.map(jax.numpy.asarray, params), tx)
    step = j_make_train_step(jmodel, tx, gradient_clip=clip, accum_steps=1, donate=False)
    state, m = step(state, tuple(None if x is None else jax.numpy.asarray(x) for x in batch),
                    lr, jax.random.PRNGKey(0))
    return jax.tree.map(float, m), flatten_dict(jax.tree.map(np.asarray, state.params))


def _assert_same_step(got, want):
    (gm, gp), (wm, wp) = got, want
    assert math.isclose(gm["loss_sum"] / gm["loss_basis"], wm["loss_sum"] / wm["loss_basis"],
                        rel_tol=LOSS_RTOL)
    assert math.isclose(gm["grad_norm"], wm["grad_norm"], rel_tol=NORM_RTOL)
    for k in ("loss_basis", "correct", "tokens"):
        assert gm[k] == wm[k], k
    assert set(gp) == set(wp)
    for n in gp:
        np.testing.assert_allclose(gp[n], wp[n], atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_dp_train_step_matches_one_process_and_jax(tmp_path):
    params = _decoder_params()
    batch = _loader_batch(np.random.default_rng(2))
    args = dict(cfg_kw=BASE, params=flatten_dict(params), batches=[batch], lr=1e-4, clip=0.05,
                accum=1, noise_kw=None)
    ranks = run_ranks("train_step", 2, tmp_path, **args)
    from torch_dist_workers import train_step

    one = train_step(0, 1, dp=False, **args)
    _assert_same_step(ranks[0], one)
    _assert_same_step(ranks[1], one)  # every rank holds the same update
    _assert_same_step(ranks[0], _jax_step(params, batch, 1e-4, 0.05))
    assert ranks[0][0]["grad_norm"] > 0.05  # the clip is active


def test_dp_train_step_with_dropout_noise_and_accum_matches_one_process(tmp_path):
    """Dropout at the ranks' element offsets, the gathered microbatch's noise,
    two accumulated loader batches: the update of one process on the whole
    meta-batch."""
    cfg_kw = {**BASE, "input_dropout": 0.1, "layer_dropout": 0.1}
    params = _decoder_params(**cfg_kw)
    rng = np.random.default_rng(3)
    batches = [_loader_batch(rng), _loader_batch(rng)]
    noise_kw = dict(scheme="GaussElemUniformAngle", embed_dim=F, vec_norm=0.5, angle_min=10.0,
                    angle_max=30.0, mix_ratio=0.15)
    args = dict(cfg_kw=cfg_kw, params=flatten_dict(params), batches=batches, lr=1e-4, clip=1.0,
                accum=2, noise_kw=noise_kw)
    ranks = run_ranks("train_step", 2, tmp_path, **args)
    from torch_dist_workers import train_step

    one = train_step(0, 1, dp=False, **args)
    no_dropout = train_step(0, 1, dp=False, **{**args, "cfg_kw": BASE})
    assert abs(one[0]["loss_sum"] - no_dropout[0]["loss_sum"]) > 1e-3  # dropout is live
    _assert_same_step(ranks[0], one)
    _assert_same_step(ranks[1], one)


# ---------------------------------------------------------------------------
# Data-parallel serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ft0_f32(tmp_path_factory):
    """The FT0 asset with float32 arrays (novic_tpu would compute with its float16)."""
    import os

    src = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
    path = str(tmp_path_factory.mktemp("ft0") / "ft0_f32.npz")
    with np.load(src) as data:
        np.savez(path, **{k: data[k].astype(np.float32) if data[k].dtype == np.float16
                          else data[k] for k in data.files})
    return path


def _unit_rows(n, seed):
    e = np.random.default_rng(seed).normal(size=(n, 768)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def test_dp_classify_embeds_matches_one_process_and_jax(ft0_f32, tmp_path):
    emb = _unit_rows(6, 11)
    gencfg = "beam_k3_vnone_gn_t1_a0"
    ranks = run_ranks("classify", 2, tmp_path, checkpoint=ft0_f32, embeds=emb, gencfg=gencfg,
                      batch_size=4)
    from novic_tpu_torch.infer import NOVICModel

    with NOVICModel(ft0_f32, embedder_spec="test:768", gencfg=gencfg, batch_size=4,
                    device="cpu") as model:
        one = model.classify_embeds(emb)
    with JNOVICModel(ft0_f32, embedder_spec="test:768", gencfg=gencfg, batch_size=4) as jmodel:
        ref = jmodel.classify_embeds(emb)
    for preds, logprobs, types in ranks:
        for want in (one, ref):
            assert preds == want.preds
            assert types == want.types
            np.testing.assert_allclose(np.array(logprobs), np.array(want.logprobs),
                                       rtol=1e-4, atol=1e-5)


def test_dp_classify_refuses_an_indivisible_batch(ft0_f32, tmp_path):
    ranks = run_ranks("classify", 2, tmp_path, checkpoint=ft0_f32, embeds=_unit_rows(3, 12),
                      gencfg="greedy_k1_vnone_gn_t1_a0", batch_size=3)
    for msg in ranks:
        assert isinstance(msg, str) and "not divisible" in msg


# ---------------------------------------------------------------------------
# Tensor-parallel towers
# ---------------------------------------------------------------------------


def _jax_arch(vision, heads=8, width=32):
    text = jvit.TextTowerConfig(context_length=16, vocab_size=64, width=width, layers=2,
                                heads=heads, embed_dim=16, compute_dtype="float32")
    base = JEmbedder.create("openai:ViT-B/32", load_model=False).arch
    return JArch(vision=vision, text=text, preprocess=base.preprocess, tokenizer=base.tokenizer,
                 family="eva02" if isinstance(vision, jeva.EvaVisionConfig) else "clip")


def _vit_vision(pool, use_cls, pre_ln, heads=8, width=32):
    return jvit.VisionTowerConfig(image_size=32, patch_size=16, width=width, layers=2,
                                  heads=heads, embed_dim=16, compute_dtype="float32", pool=pool,
                                  use_class_token=use_cls, pre_ln=pre_ln,
                                  patch_bias=not use_cls)


def _eva_vision(qkv_fused, swiglu):
    return jeva.EvaVisionConfig(image_size=32, patch_size=16, width=32, layers=2, heads=8,
                                mlp_hidden=16, embed_dim=16, use_rope=True, ref_feat_shape=2,
                                swiglu=swiglu, inner_attn_norm=True, qkv_fused=qkv_fused,
                                compute_dtype="float32")


def _port_arch(jarch):
    vcls = peva.EvaVisionConfig if jarch.family == "eva02" else pvit.VisionTowerConfig
    return EmbedderArch(vision=vcls(**dataclasses.asdict(jarch.vision)),
                        text=pvit.TextTowerConfig(**dataclasses.asdict(jarch.text)),
                        preprocess=PreprocessConfig(**dataclasses.asdict(jarch.preprocess)),
                        tokenizer=jarch.tokenizer, family=jarch.family)


def _jax_embedder(jarch, tmp_path):
    """novic_tpu's embedder on the arch, with its random init moved by seeded
    noise (so biases and norm scales are not 0 and 1, and a bias added on every
    rank shows), and those params as an .npz."""
    from novic_tpu.embedders.base import JaxEmbedder

    kw = dict(spec="openclip:tiny", arch=jarch, tokenizer_batch_size=8, inference_batch_size=4,
              image_batch_size=4, load_model=True, check=False, bpe_merges_path=None,
              tokenizer=None, compute_dtype="float32", seed=3)
    init = JaxEmbedder(weights_path=None, **kw)
    rng = np.random.default_rng(4)
    moved = [jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a)))
                          .astype(np.float32), tree)
             for tree in (init._vision_params, init._text_params)]
    path = str(tmp_path / "towers.npz")
    save_params_npz(path, *moved)
    return JaxEmbedder(weights_path=path, **kw), path


def _inputs(n=4):
    rng = np.random.default_rng(5)
    images = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 64, size=(n, 16)).astype(np.int32)
    tokens[:, -3:] = 0
    return images, tokens


def _check_tp(jarch, tmp_path, mode="tp", shape=(2,), axes=("model",)):
    jemb, path = _jax_embedder(jarch, tmp_path)
    images, tokens = _inputs()
    ref_img = jemb.inference_image(images)
    ref_txt = jemb.inference_tokens({"input_ids": tokens})
    world = int(np.prod(shape))
    args = dict(arch=_port_arch(jarch), weights=path, images=images, tokens=tokens)
    ranks = run_ranks("tower_embed", world, tmp_path, mode=mode, shape=shape, axes=axes, **args)
    from torch_dist_workers import tower_embed

    one_img, one_txt, full_shapes = tower_embed(0, 1, mode=None, shape=None, axes=None, **args)
    np.testing.assert_allclose(one_img, ref_img, atol=TP_ATOL)
    np.testing.assert_allclose(one_txt, ref_txt, atol=TP_ATOL)
    for img, txt, shapes in ranks:
        np.testing.assert_allclose(img, one_img, atol=TP_ATOL)
        np.testing.assert_allclose(txt, one_txt, atol=TP_ATOL)
        np.testing.assert_allclose(img, ref_img, atol=TP_ATOL)
        np.testing.assert_allclose(txt, ref_txt, atol=TP_ATOL)
        n = dict(zip(axes, shape)).get("model", 1)
        for name, full in full_shapes.items():  # the params are really cut
            spec = ptp.tp_param_spec(name)
            want = list(full)
            if spec in (ptp.COLUMN, ptp.COLUMN_BIAS):
                want[0] //= n
            elif spec == ptp.ROW:
                want[1] //= n
            assert list(shapes[name]) == want, name
    return ranks


@pytest.mark.parametrize("pool,use_cls,pre_ln", [("cls", True, True), ("map", False, False),
                                                 ("avg", True, False)])
def test_tp2_towers_match_one_process_and_jax(pool, use_cls, pre_ln, tmp_path):
    _check_tp(_jax_arch(_vit_vision(pool, use_cls, pre_ln)), tmp_path)


@pytest.mark.parametrize("qkv_fused,swiglu", [(False, True), (True, False)])
def test_tp2_eva_tower_matches_one_process_and_jax(qkv_fused, swiglu, tmp_path):
    """EVA02 trunks: SwiGLU with mlp_norm over the cut hidden dim (split qkv),
    and the enormous variant's fused-qkv plain MLP; both with the sub-LN over
    the local heads' output."""
    _check_tp(_jax_arch(_eva_vision(qkv_fused, swiglu)), tmp_path)


def test_dp_tp_2x2_mesh_matches_one_process_and_jax(tmp_path):
    """4 ranks: batch on 'data', TP on 'model' (the map pool: its head is cut too)."""
    _check_tp(_jax_arch(_vit_vision("map", False, False)), tmp_path, mode="dp_tp",
              shape=(2, 2), axes=("data", "model"))


def test_set_mesh_refusals(tmp_path):
    heads3 = _port_arch(_jax_arch(_vit_vision("cls", True, True, heads=3, width=48), heads=3,
                                  width=48))
    ok = _port_arch(_jax_arch(_vit_vision("cls", True, True)))
    align = next(a for a in REGISTRY.values() if a.family == "align")
    ranks = run_ranks("embedder_refusals", 2, tmp_path, arch_dp=ok, arch_heads3=heads3,
                      align_arch=align)
    for unknown, heads, align_msg in ranks:
        assert "Unknown mesh mode" in unknown
        assert "not divisible" in heads
        assert "not supported for the ALIGN" in align_msg
    ptp.validate_tp_divisibility(heads3.vision, axis_size=3)  # 3 % 3 == 0


def test_validate_tp_divisibility_messages_match_jax():
    cfg = jvit.VisionTowerConfig(width=48, heads=6)
    pcfg = pvit.VisionTowerConfig(width=48, heads=6)
    for size in (4, 5):
        with pytest.raises(ValueError) as jerr:
            jtp.validate_tp_divisibility(cfg, axis_size=size)
        with pytest.raises(ValueError) as perr:
            ptp.validate_tp_divisibility(pcfg, axis_size=size)
        assert str(perr.value) == str(jerr.value)


def _jax_layout(name):
    spec = jtp.tp_param_spec((jax.tree_util.DictKey(name.rsplit(".", 1)[-1]),), None, "model")
    P = jax.sharding.PartitionSpec
    return {P("model", None): ptp.COLUMN, P("model"): ptp.COLUMN_BIAS,
            P(None, "model"): ptp.ROW, P(): ptp.REPLICATED}[spec]


@pytest.mark.parametrize("family", ["clip", "siglip", "clipa", "eva02", "align"])
def test_tp_param_spec_matches_jax_for_every_registered_leaf(family):
    archs = [a for a in REGISTRY.values() if a.family == family]
    assert archs
    seen = set()
    for arch in archs:
        with torch.device("meta"):
            towers = tower_modules(arch)
        for tower in towers:
            for name, _ in tower.named_parameters():
                assert ptp.tp_param_spec(name) == _jax_layout(name), name
                seen.add(ptp.tp_param_spec(name))
    if family == "align":  # its conv and BERT leaves match no table: TP is refused
        assert seen == {ptp.REPLICATED}
    else:
        assert {ptp.COLUMN, ptp.COLUMN_BIAS, ptp.ROW, ptp.REPLICATED} <= seen


def test_shard_tower_state_cuts_by_name():
    sd = {"blocks_0.attn.q_proj_weight": torch.arange(32.).reshape(4, 8),
          "blocks_0.attn.q_proj_bias": torch.arange(4.),
          "blocks_0.attn.out_proj_weight": torch.arange(32.).reshape(8, 4),
          "blocks_0.attn.out_proj_bias": torch.arange(8.),
          "pos_embedding": torch.ones(3, 8)}
    for rank in (0, 1):
        out = ptp.shard_tower_state(sd, rank, 2)
        assert torch.equal(out["blocks_0.attn.q_proj_weight"], sd["blocks_0.attn.q_proj_weight"][2 * rank:2 * rank + 2])
        assert torch.equal(out["blocks_0.attn.q_proj_bias"], sd["blocks_0.attn.q_proj_bias"][2 * rank:2 * rank + 2])
        assert torch.equal(out["blocks_0.attn.out_proj_weight"], sd["blocks_0.attn.out_proj_weight"][:, 2 * rank:2 * rank + 2])
        assert out["blocks_0.attn.out_proj_bias"] is sd["blocks_0.attn.out_proj_bias"]
        assert out["pos_embedding"] is sd["pos_embedding"]


# ---------------------------------------------------------------------------
# Data-parallel training through the CLI
# ---------------------------------------------------------------------------

NOUNS = ["dog", "cat", "fire truck", "sea lion", "tree", "car", "hot dog", "apple"]


@pytest.fixture(scope="module")
def train_workdir(tmp_path_factory):
    """A 160-row embedding cache of the test embedder's width over NOUNS."""
    import json

    from novic_tpu_torch.data.cache import EmbeddingCacheWriter
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.text.target import TargetTokenizer, create_target_config

    d = tmp_path_factory.mktemp("dp_cli")
    with open(d / "vocab.json", "w") as f:
        json.dump([{"target_noun": n} for n in NOUNS], f)
    tok = make_test_tokenizer(NOUNS)
    tc = create_target_config(tok, NOUNS, with_start_token=False, with_end_token=True,
                              compact_ids=True, fixed_token_length=False,
                              auto_fixed_token_length=True, use_masks=True)
    rng = np.random.default_rng(0)
    n, f = 160, 32
    idx = rng.integers(0, len(NOUNS), size=(n, 1))
    e = rng.normal(size=(n, f)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    with EmbeddingCacheWriter(str(d / "cache.bin"), num_embed=n, embed_dim=f,
                              target_tokenizer=TargetTokenizer(tok, tc), target_nouns=NOUNS,
                              num_embed_targets=1, shuffle=True, seed=3, embedder_strict=True,
                              embedder_hash=bytes(range(32)), default_weights=True) as writer:
        writer.write(e, (idx + 1).astype(np.int32), None)
    return d


def _cli_args(d, out):
    return ["action=train", "--device=cpu", "embedder=test:32", f"vocab_path={d}/vocab.json",
            "seed=1", f"output_dir={d}/{out}", f"embedding_dataset={d}/cache.bin",
            "batch_size=8", "accum_factor=2", "hidden_dim=32", "num_layers=2", "num_heads=4",
            "mlp_seq_len=2", "input_dropout=0.1", "layer_dropout=0.1", "init_lr=3e-3",
            "noise_scheme=GaussElem", "noise_vec_norm=0.5", "chunk_scale=4", "max_chunks=2",
            "save_every_max=2", "save_top1_min=200", "strict_embedder=false",
            "dataset_workers=1"]


def test_dp_cli_training_matches_one_process(train_workdir, tmp_path):
    """action=train on 2 ranks (data_parallel=true, the default) trains the
    model one process trains, and only rank 0 writes a run directory."""
    import glob

    from torch_dist_workers import cli_train

    ranks = run_ranks("cli_train", 2, tmp_path, argv=_cli_args(train_workdir, "dp"))
    one = cli_train(0, 1, _cli_args(train_workdir, "one"))
    assert len(glob.glob(f"{train_workdir}/dp/ovod_*")) == 1
    assert len(glob.glob(f"{train_workdir}/dp/ovod_*/*.npz")) == 1
    for params, counters, loss in ranks:
        assert counters == one[1]
        assert math.isclose(loss, one[2], rel_tol=1e-5)
        for name, p in params.items():
            np.testing.assert_allclose(p, one[0][name], atol=PARAM_ATOL, rtol=0, err_msg=name)
