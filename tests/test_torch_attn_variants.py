"""Port ViT-B/16 attention-variants harness (novic_tpu_torch.exp.attn_variants)
against exp/attn_variants.py, and the DFN5B harness's flash variant against
exp/dfn5b_attention.py's `make_attn_flash`, with JAX's flash-attention kernel
in TPU interpret mode on the CPU.

exp/attn_variants.py builds its params and times at import, so only its
imports, its shape constants and its function definitions are loaded,
through `ast`, and its global B (which `attn_flash` and the towers read) is
set to the test's batch. The towers run at 2 layers and a narrow width (E=128,
2 heads of 64, FF=512; S=196, padded to 256 for attn_flash as in the file) on
the same numpy-seeded weights, every variant and `tower_bhsd`; the DFN5B
harness's tower at its full width (E=1280, 16 heads of 80, S=730), B=1, 2
layers, with `make_attn_flash` at the check's blocks (256) and the resid16
run's (768).

Bars: the port's flash variants take the kernel's plain version at JAX's
blocking, and the chains round the same bf16 operands; the towers differ
where JAX rounds bf16 op by op and torch once (gelu, the bf16 softmax), by a
bf16 ulp here and there, so they are held to a cosine per token of 0.9999
and a relative Frobenius error of 5e-3 (bf16 scores and softmax: 0.999 and
2e-2). The attention functions alone, at the file's check shape (B=4, 12
heads of 64), to one bf16 ulp plus 2^-7 * max|v| (flash) and 2^-7 * max|v|
plus 1e-5 (the float32 chain).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import exp.dfn5b_attention as jx2
from novic_tpu_torch.bridge import harness_params_from_numpy
from novic_tpu_torch.exp import attn_variants as port
from novic_tpu_torch.exp import dfn5b_attention as port_x2

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
KEEP = {"B", "S", "E", "H", "L", "FF", "hd", "INNER", "ITERS", "bf16", "dense", "ln",
        "attn_xla_f32", "attn_xla_bf16", "attn_xla_bf16_f32sm", "attn_flash", "tower",
        "tower_bhsd"}
BATCH, E, HEADS, FF = 2, 128, 2, 512
BF16_SCORES = ("attn_xla_bf16", "tower_bhsd")


def _load_variants() -> dict:
    """exp/attn_variants.py's imports, shape constants and function
    definitions, without the params, the check and the timing at import."""
    tree = ast.parse((REPO / "exp" / "attn_variants.py").read_text())
    stop = min(n.lineno for n in tree.body if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "Bsave" for t in n.targets))
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.Assign) and node.lineno < stop:
            names = {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
            if names <= KEEP:
                keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in KEEP:
            keep.append(node)
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "exp/attn_variants.py", "exec"), ns)
    assert (ns["B"], ns["S"], ns["E"], ns["H"], ns["L"], ns["FF"]) == (256, 196, 768, 12, 12, 3072)
    assert (port.B, port.S, port.E, port.H, port.L, port.FF) == (256, 196, 768, 12, 12, 3072)
    return ns


@pytest.fixture(scope="module")
def jav():
    return _load_variants()


def _cos(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _params(layers: int, seed: int) -> list[dict]:
    """The file's keys and (out, in) shapes at the narrow width; biases and
    norm scales drawn too, so every term is exercised."""
    rng = np.random.default_rng(seed)

    def mk(*shape, std=0.02, mean=0.0):
        return (mean + rng.normal(0, std, shape)).astype(np.float32)

    return [dict(n1w=mk(E, mean=1.0), n1b=mk(E), n2w=mk(E, mean=1.0), n2b=mk(E),
                 wq=mk(E, E), bq=mk(E), wk=mk(E, E), bk=mk(E), wv=mk(E, E), bv=mk(E),
                 wo=mk(E, E), bo=mk(E), w1=mk(FF, E), b1=mk(FF), w2=mk(E, FF), b2=mk(E))
            for _ in range(layers)]


@pytest.mark.parametrize("name", list(port.VARIANTS) + ["tower_bhsd"])
def test_tower_matches_jax(jav, monkeypatch, name):
    monkeypatch.setattr(port, "E", E)
    monkeypatch.setattr(port, "H", HEADS)
    monkeypatch.setitem(jav, "B", BATCH)
    monkeypatch.setitem(jav, "E", E)
    monkeypatch.setitem(jav, "H", HEADS)
    assert jav["hd"] == port.hd == E // HEADS  # 64, as in the file
    params = _params(2, 3)
    x0 = np.random.default_rng(4).normal(size=(BATCH, port.S, E)).astype(np.float32)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    # Jitted whole: an eager op dispatched while the interpreted kernel's
    # callbacks run can deadlock
    if name == "tower_bhsd":
        run = jax.jit(lambda x, p: jav["tower_bhsd"](x, p))
    else:
        run = jax.jit(lambda x, p: jav["tower"](x, jav[name], p))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(run(jnp.asarray(x0), jp), np.float32)
    tp = harness_params_from_numpy(params)
    with torch.no_grad():
        x = torch.from_numpy(x0)
        out = port.tower_bhsd(x, tp) if name == "tower_bhsd" else port.tower(x, port.VARIANTS[name], tp)
    out = out.float().numpy()
    assert out.shape == ref.shape == (BATCH, port.S, E)
    cos_bar, fro_bar = (0.999, 2e-2) if name in BF16_SCORES else (0.9999, 5e-3)
    assert _cos(out, ref).min() >= cos_bar, _cos(out, ref).min()
    assert np.linalg.norm(out - ref) <= fro_bar * np.linalg.norm(ref)


def test_attention_at_the_check_shape_matches_jax(jav, monkeypatch):
    """The file's check shape (B=4, S=196, 12 heads of 64): attn_flash and
    attn_xla_f32 against the file's, and the port's check runs."""
    monkeypatch.setitem(jav, "B", 4)
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(4, port.S, port.H, port.hd)).astype(np.float32) for _ in range(3))
    vb = torch.from_numpy(v).to(torch.bfloat16).float()
    vmax = vb.abs().amax(dim=1, keepdim=True).numpy()  # over keys
    with pltpu.force_tpu_interpret_mode():
        ref_flash = np.asarray(jav["attn_flash"](*(jnp.asarray(t) for t in (q, k, v))))
        ref_f32 = np.asarray(jav["attn_xla_f32"](*(jnp.asarray(t) for t in (q, k, v))))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    out_flash = port.attn_flash(tq, tk, tv).numpy()
    out_f32 = port.attn_xla_f32(tq, tk, tv).numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref_flash), 1e-30))) - 7)
    assert (np.abs(out_flash - ref_flash) <= ulp + 2.0 ** -7 * vmax).all()
    assert (np.abs(out_f32 - ref_f32) <= 1e-5 + 2.0 ** -7 * vmax).all()
    diff = port.check("cpu")
    assert 0 < diff < 0.05  # bf16 output and P rounding, as the file's check prints


@pytest.mark.parametrize("blocks", [256, 768])
def test_dfn5b_flash_variant_matches_jax(blocks):
    """exp/dfn5b_attention.py's tower with make_attn_flash(blocks, blocks), B=1,
    2 layers at full width, against the port's, on params drawn as
    tests/test_torch_dfn5b.py draws the X2 harness's."""
    rng = np.random.default_rng(9)
    mk = lambda *shape: rng.normal(0, 0.02, shape).astype(np.float32)  # noqa: E731
    Ew, Fw = jx2.E, jx2.FF
    params = [{"wq": mk(Ew, Ew), "wk": mk(Ew, Ew), "wv": mk(Ew, Ew), "wo": mk(Ew, Ew),
               "bq": mk(Ew), "bk": mk(Ew), "bv": mk(Ew), "bo": mk(Ew),
               "n1w": np.ones(Ew, np.float32), "n1b": np.zeros(Ew, np.float32),
               "n2w": np.ones(Ew, np.float32), "n2b": np.zeros(Ew, np.float32),
               "w1": mk(Ew, Fw), "b1": mk(Fw), "w2": mk(Fw, Ew), "b2": mk(Ew)} for _ in range(2)]
    x0 = np.random.default_rng(10).normal(size=(1, jx2.S, Ew)).astype(np.float32)
    run = jax.jit(lambda p, x: jx2.tower(p, x, jx2.make_attn_flash(blocks, blocks), batch=1))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(run([{k: jnp.asarray(v) for k, v in p.items()} for p in params],
                             jnp.asarray(x0)))
    with torch.no_grad():
        out = port_x2.tower(harness_params_from_numpy(params), torch.from_numpy(x0),
                            port_x2.make_attn_flash(blocks, blocks)).numpy()
    assert out.shape == ref.shape == (1, jx2.S, Ew)
    assert _cos(out[0], ref[0]).min() >= 0.9999
    assert np.linalg.norm(out - ref) <= 5e-3 * np.linalg.norm(ref)
