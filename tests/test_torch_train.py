"""The port's training path (novic_tpu_torch models, train.step, train.optim)
against novic_tpu on the CPU, at a small width.

Both run exact float32 (JAX at matmul_precision="highest"), dropout off, with
the same parameters carried across by bridge.py and the same numpy inputs:
  * forward: logits, loss_sum, loss_basis and correct agree to 1e-5 relative
    (float32 sums in another order) for every target layout the decoder takes;
  * grads: jax.grad and autograd agree to 1e-5 relative Frobenius per param;
  * one train step (clip + AdamW): loss and pre-clip grad norm to 1e-5
    relative, the updated params to 1e-6 absolute. Adam's first update is
    lr * g / (|g| + eps), close to lr * sign(g): where a gradient element is
    tiny, float noise in it moves the update by up to ~lr, so these steps use
    lr = 1e-4 (1e-3 without clipping, where fewer elements are tiny);
  * accum_steps=2 and steps_per_call=2 agree the same way;
  * the LR schedule is equal; random init matches flax's in distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novic_tpu.models.base import create_decoder as j_create_decoder
from novic_tpu.models.config import DecoderModelConfig as JConfig
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.train.optim import create_optimizer as j_create_optimizer
from novic_tpu.train.optim import lr_schedule_per_chunk as j_schedule
from novic_tpu.train.step import create_train_state, make_train_step as j_make_train_step
from novic_tpu_torch.bridge import decoder_from_numpy, decoder_to_numpy
from novic_tpu_torch.models.base import count_params, create_decoder, verify_unused
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.train.optim import create_optimizer, lr_schedule_per_chunk
from novic_tpu_torch.train.step import TrainRng, TrainState, make_train_step
from novic_tpu_torch.utils.misc import flatten_dict

torch.set_num_threads(2)
RTOL = 1e-5     # float32 in another summation order
PARAM_ATOL = 1e-6
F, V, C, B = 24, 40, 5, 6
BASE = dict(embed_dim=F, vocab_size=V, token_length=C, hidden_dim=32, num_layers=2, num_heads=4,
            mlp_seq_len=3, input_dropout=0.0, layer_dropout=0.0, matmul_precision="highest")


def _models(**overrides):
    kw = {**BASE, **overrides}
    jcfg = JConfig(**kw)
    _, params = j_create_decoder(jcfg, rng=jax.random.PRNGKey(1))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = decoder_from_numpy(DecoderModelConfig(**kw), params)
    return JDecoder(cfg=jcfg), params, model


def _targets(rng, shape, min_len=1):
    """Token ids with trailing padding (id 0), the padding mask (True = pad)."""
    lengths = rng.integers(min_len, shape[-1] + 1, size=shape[:-1])
    pos = np.arange(shape[-1])
    pad = pos >= lengths[..., None]
    tok = np.where(pad, 0, rng.integers(1, V, size=shape)).astype(np.int32)
    return tok, pad


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(kind, rng):
    embed = rng.normal(size=(B, F)).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    weight = None
    if kind in ("bxmxc", "mxbxc"):
        M = 3
        shape = (B, M, C) if kind == "bxmxc" else (M, B, C)
        tok, pad = _targets(rng, shape)
        weight = rng.uniform(0.1, 1.0, size=shape[:2]).astype(np.float32)
        weight[(1, 2) if kind == "bxmxc" else (2, 1)] = 0.0  # a zero-weight target
    else:
        tok, pad = _targets(rng, (B, C))
    return embed, tok, pad, weight


CASES = [
    ("bxc", {}, {}),
    ("bxc", {"num_end_loss": 2}, {}),
    ("bxc", {"label_smoothing": 0.1}, {}),
    ("bxc", {"vocab_quant": True, "logits_bias": True, "init_bias_zero": False}, {}),
    ("bxc", {}, {"guide": True}),
    ("bxc", {"layer_norm_first": False, "layer_bias": True, "init_rezero_mode": "perskip"}, {}),
    ("bxmxc", {}, {}),
    ("mxbxc", {}, {"multi_first": True}),
]


@pytest.mark.parametrize("kind,cfg_kw,call_kw", CASES)
def test_forward_matches_jax(kind, cfg_kw, call_kw):
    jmodel, params, model = _models(**cfg_kw)
    rng = np.random.default_rng(0)
    embed, tok, pad, weight = _batch(kind, rng)
    guide = None
    if call_kw.get("guide"):
        guide, _ = _targets(rng, (7, C))
        guide[:3] = tok[:3]  # some targets continue a guide target
    kwargs = dict(calc_loss=True, calc_correct=True, multi_first=call_kw.get("multi_first", False))
    j = jmodel.apply({"params": params}, jnp.asarray(embed), jnp.asarray(tok), jnp.asarray(pad),
                     None if weight is None else jnp.asarray(weight),
                     guide_targets=None if guide is None else jnp.asarray(guide), **kwargs)
    with torch.no_grad():
        p = model(torch.from_numpy(embed), torch.from_numpy(tok), torch.from_numpy(pad),
                  None if weight is None else torch.from_numpy(weight),
                  guide_targets=None if guide is None else torch.from_numpy(guide), **kwargs)
    logits, pad_out, loss_sum, loss_basis, correct = p
    assert _rel(logits.numpy(), j[0]) <= RTOL
    np.testing.assert_array_equal(pad_out.numpy(), np.asarray(j[1]))
    assert abs(loss_sum.item() - float(j[2])) <= RTOL * abs(float(j[2]))
    assert abs(loss_basis.item() - float(j[3])) <= RTOL * abs(float(j[3]))
    np.testing.assert_array_equal(correct.numpy(), np.asarray(j[4]))


def _loss_fn_jax(jmodel, embed, tok, pad, weight):
    def lf(p):
        _, _, s, b, _ = jmodel.apply({"params": p}, jnp.asarray(embed), jnp.asarray(tok),
                                     jnp.asarray(pad), weight, calc_loss=True)
        return s / b
    return lf


@pytest.mark.parametrize("cfg_kw", [{}, {"vocab_quant": True, "label_smoothing": 0.1},
                                    {"weight_tying": False, "mlp_hidden_layer": "min",
                                     "mlp_hidden_norm": True, "mlp_hidden_bias": True}])
def test_grads_match_jax(cfg_kw):
    jmodel, params, model = _models(**cfg_kw)
    embed, tok, pad, _ = _batch("bxc", np.random.default_rng(1))
    jgrads = flatten_dict(jax.tree.map(np.asarray,
                                       jax.grad(_loss_fn_jax(jmodel, embed, tok, pad, None))(params)))
    _, _, s, b, _ = model(torch.from_numpy(embed), torch.from_numpy(tok), torch.from_numpy(pad),
                          calc_loss=True)
    (s / b).backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for n in grads:
        if np.linalg.norm(jgrads[n]) == 0:
            np.testing.assert_array_equal(grads[n], 0.0)
        else:
            assert _rel(grads[n], jgrads[n]) <= RTOL, n


def _jax_step(jmodel, params, batch, lr, *, accum=1, clip=0.05, wd=0.1, wd_1d=True, shift=None,
              steps=1):
    tx = j_create_optimizer(weight_decay=wd, weight_decay_1d=wd_1d)
    state = create_train_state(jax.tree.map(jnp.asarray, params), tx)
    step = j_make_train_step(jmodel, tx, gradient_clip=clip, accum_steps=accum, donate=False,
                             mean_shift=shift)
    out = []
    for _ in range(steps):
        state, m = step(state, tuple(None if x is None else jnp.asarray(x) for x in batch),
                        lr, jax.random.PRNGKey(0))
        out.append(jax.tree.map(float, m))
    return flatten_dict(jax.tree.map(np.asarray, state.params)), out


def _port_step(model, batch, lr, *, accum=1, clip=0.05, wd=0.1, wd_1d=True, shift=None,
               steps=1, steps_per_call=1):
    opt = create_optimizer(model.named_parameters(), weight_decay=wd, weight_decay_1d=wd_1d)
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(state, gradient_clip=clip, accum_steps=accum, mean_shift=shift,
                           steps_per_call=steps_per_call)
    rng = TrainRng.create(0, "cpu")
    tb = tuple(None if x is None else torch.from_numpy(x) for x in batch)
    if steps_per_call > 1:
        m = step([tb] * steps_per_call, [lr] * steps_per_call, rng).fetch()
        out = [{k: float(v[i]) for k, v in m.items()} for i in range(steps_per_call)]
    else:
        out = [{k: float(v) for k, v in step(tb, lr, rng).fetch().items()} for _ in range(steps)]
    assert state.step == steps * steps_per_call
    return {n: p.detach().numpy() for n, p in model.named_parameters()}, out


def _compare_steps(jp, jm, pp, pm):
    for a, b in zip(pm, jm):
        assert abs(a["loss_sum"] / a["loss_basis"] - b["loss_sum"] / b["loss_basis"]) <= \
            RTOL * abs(b["loss_sum"] / b["loss_basis"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= RTOL * b["grad_norm"]
        for k in ("loss_basis", "correct", "tokens"):
            assert a[k] == b[k], k
    assert set(pp) == set(jp)
    for n in pp:
        np.testing.assert_allclose(pp[n], jp[n], atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_one_step_with_clip_and_adamw_matches_jax():
    jmodel, params, model = _models()
    batch = _batch("bxc", np.random.default_rng(2))
    shift = np.random.default_rng(3).normal(size=(F,)).astype(np.float32) * 0.1
    jp, jm = _jax_step(jmodel, params, batch, 1e-4, shift=shift)
    assert jm[0]["grad_norm"] > 0.05  # the clip is active
    pp, pm = _port_step(model, batch, 1e-4, shift=shift)
    _compare_steps(jp, jm, pp, pm)


def test_accum_steps_2_matches_jax():
    jmodel, params, model = _models()
    rng = np.random.default_rng(4)
    b1, b2 = _batch("bxc", rng), _batch("bxc", rng)
    batch = tuple(np.concatenate([x, y]) if x is not None else None for x, y in zip(b1, b2))
    jp, jm = _jax_step(jmodel, params, batch, 1e-4, accum=2, clip=1.0)
    pp, pm = _port_step(model, batch, 1e-4, accum=2, clip=1.0)
    _compare_steps(jp, jm, pp, pm)


def test_steps_per_call_equals_single_steps():
    jmodel, params, model = _models()
    batch = _batch("bxc", np.random.default_rng(5))
    jp, jm = _jax_step(jmodel, params, batch, 1e-4, steps=2)
    pp, pm = _port_step(model, batch, 1e-4, steps_per_call=2)
    _compare_steps(jp, jm, pp, pm)


def test_weight_decay_groups_and_the_jax_mask_quirk():
    """The port's AdamW gives the JAX trainer's update in both settings. The
    JAX package's mask callable evaluates to the scalar weight_decay_1d, so
    with False nothing decays (not even the ndim >= 2 params the mask names)
    and with True everything does; the port decays the same parameters."""
    jmodel, params, _ = _models()
    batch = _batch("bxc", np.random.default_rng(6))
    kw = dict(clip=0.0)  # decay moves a param by lr * wd * |p| ~ 2e-5 here, far above 1e-6
    j_nodecay, _ = _jax_step(jmodel, params, batch, 1e-3, wd=0.0, wd_1d=False, **kw)
    for wd_1d in (False, True):
        jp, _ = _jax_step(jmodel, params, batch, 1e-3, wd=0.1, wd_1d=wd_1d, **kw)
        if not wd_1d:
            for n in jp:
                np.testing.assert_array_equal(jp[n], j_nodecay[n])  # the quirk
        else:
            assert any(np.abs(jp[n] - j_nodecay[n]).max() > 10 * PARAM_ATOL for n in jp
                       if jp[n].ndim < 2)  # 1-D params decay too
        port, _ = _port_step(decoder_from_numpy(_models()[2].cfg, params), batch, 1e-3,
                             wd=0.1, wd_1d=wd_1d, **kw)
        assert set(port) == set(jp)
        for n, v in port.items():
            np.testing.assert_allclose(v, jp[n], atol=PARAM_ATOL, rtol=0, err_msg=f"{n} {wd_1d}")


def test_vocab_quant_rows_stay_zero_through_adamw():
    cfg = DecoderModelConfig(**{**BASE, "vocab_quant": True, "logits_bias": True,
                                "init_bias_zero": False})
    model = create_decoder(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert cfg.vocab_size_quant > cfg.vocab_size
    verify_unused(model, cfg)
    batch = _batch("bxc", np.random.default_rng(7))
    _port_step(model, batch, 1e-2, wd=0.1, wd_1d=True, steps=3)
    verify_unused(model, cfg)
    assert float(model.logits_weight.detach()[:cfg.vocab_size].abs().sum()) > 0
    with torch.no_grad():
        model.logits_weight[-1, 0] = 1.0
    with pytest.raises(ValueError, match="unused"):
        verify_unused(model, cfg)


def test_dropout_sites_draw_from_the_generator():
    _, _, model = _models(input_dropout=0.2, layer_dropout=0.2)
    embed, tok, pad, _ = _batch("bxc", np.random.default_rng(8))
    args = (torch.from_numpy(embed), torch.from_numpy(tok), torch.from_numpy(pad))

    def loss(deterministic, seed=0):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out = model(*args, calc_loss=True, deterministic=deterministic, generator=gen)
        return out[2].item(), gen

    det, _ = loss(True)
    a, gen_a = loss(False)
    b, _ = loss(False)
    assert a == b and a != det and a != loss(False, seed=1)[0]
    # 25 draws at 6 layers are 1 + 4 per layer; here 1 + 4 * 2, two words each
    fresh = torch.Generator().manual_seed(0)
    torch.randint(0, 2 ** 32, (2 * (1 + 4 * BASE["num_layers"]),), generator=fresh,
                  dtype=torch.int64)
    assert torch.equal(fresh.get_state(), gen_a.get_state())
    model.set_dropout(0.0, 0.0)
    assert loss(False)[0] == det


@pytest.mark.parametrize("sched,warmup,final,start", [
    ("const", 0, 0.0, 1), ("const", 3, 0.0, 1), ("cosine", 0, 0.0, 1), ("cosine", 2, 1e-4, 1),
    ("cosine", 4, 0.0, 5), ("COSINE", 1, 1e-5, 3)])
def test_lr_schedule_equal(sched, warmup, final, start):
    a = lr_schedule_per_chunk(1.5e-3, final, sched, warmup, 20, start_chunk=start)
    b = j_schedule(1.5e-3, final, sched, warmup, 20, start_chunk=start)
    assert [a(c) for c in range(1, 25)] == [b(c) for c in range(1, 25)]


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"init_tfrm_mode": "open", "init_mlp_mode": "default", "layer_bias": True,
     "init_bias_zero": False},
    {"init_tfrm_mode": "default", "layer_norm_first": False, "mlp_hidden_layer": "max",
     "mlp_hidden_norm": True, "init_mlp_unit_norm": True, "init_tfrm_unit_norm": True},
    {"vocab_quant": True, "weight_tying": False, "logits_bias": True, "init_bias_zero": False,
     "init_zero_norm": True, "init_rezero_mode": "perlayer"},
])
def test_init_statistics_match_flax(cfg_kw):
    kw = {**BASE, "hidden_dim": 64, "vocab_size": 300, **cfg_kw}
    jcfg, cfg = JConfig(**kw), DecoderModelConfig(**kw)
    _, jparams = j_create_decoder(jcfg, rng=jax.random.PRNGKey(0))
    jflat = flatten_dict(jax.tree.map(np.asarray, jparams))
    model = create_decoder(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    flat = flatten_dict(decoder_to_numpy(model))
    assert set(flat) == set(jflat)
    for n, v in flat.items():
        ref = jflat[n]
        assert v.shape == ref.shape, n
        if cfg.vocab_quant and n in ("logits_weight", "logits_bias", "token_embedding"):
            np.testing.assert_array_equal(v[cfg.vocab_size:], 0.0)
            v, ref = v[:cfg.vocab_size], ref[:cfg.vocab_size]
        if np.all(ref == ref.flat[0]):  # constant initialisers: equal
            np.testing.assert_array_equal(v, ref, err_msg=n)
            continue
        # Random: same mean and std within 6 standard errors of the std estimate
        n_el = v.size
        tol = 6.0 / math.sqrt(2 * n_el)
        assert abs(v.std() / ref.std() - 1) <= 2 * tol, (n, v.std(), ref.std())
        assert abs(v.mean() - ref.mean()) <= 6 * ref.std() / math.sqrt(n_el), n
    assert count_params(model, cfg)["total"] == sum(a.size for a in jflat.values())
