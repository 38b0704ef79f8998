"""Port flash attention's backward (X6b) and the forward's causal and ab
options (novic_tpu_torch.ops.flash_attention) against JAX's TPU
flash-attention kernels and their custom VJP, run in TPU interpret mode on
the CPU, and the CUDA wrappers' plumbing under a recording fake library.

On the CPU `FlashAttentionFn` runs the plain forward in JAX's blocking
(block_k 128, the full BlockSizes with forward and backward blocks of 128)
and the plain backward. Inputs are numpy-seeded bf16, hd 64 and 80, with no
segment ids, padding, packed and masked-row segment ids, causal, a float32
ab, causal with segments (a row whose visited keys are all masked) and a
float32 ab together, and Sq != Skv with causal, padding and a bf16 ab. Each
case is one jitted JAX call giving o, l, m and the VJP's dq, dk, dv, dab.

Bars: both sides take the same exact products of bf16 values in float32 and
sum them in another order, and exp differs in its last bits, so a bf16
rounding of p or ds can land one ulp (2^-8 relative) apart. That moves o by
at most 2^-7 * max|v| over the keys, and a gradient by at most 2^-7 of the
largest magnitude among its elements; the bf16 result may then round one ulp
apart. So o is held to one bf16 ulp of JAX's value plus 2^-7 * max|v|, each
of dq, dk, dv and dab to one bf16 ulp plus 2^-7 * max|JAX's gradient|, and
l and m (float32, the same blocked sums in the same order, exp and the
q·k sums in their last bits) to 1e-5 relative (m: of max(|m|, 1)).

The harness tower (novic_tpu_torch.exp.attn_variants `tower` with
`attn_flash`, 2 layers, E=128, 2 heads of 64, FF=512, B=2, S=196 padded to
256) against `jax.grad` of exp/attn_variants.py's `tower`: the file builds
its params and times at import, so its definitions are loaded through `ast`
(as tests/test_torch_attn_variants.py does), and its `attn_flash` passes
BlockSizes without backward blocks (JAX raises when differentiated), so
this test alone monkeypatches JAX's `BlockSizes` to add them (256, the
forward's). The towers round bf16 at other points op by op (gelu, the
residual adds), so each parameter gradient and the input gradient are held
to a cosine of 0.9999 and a relative Frobenius error of 1e-2 (measured:
0.99999 and 4.5e-3). The key bias bk is the exception: the softmax is
invariant to a constant added to a row's scores, so its exact gradient is 0
and both sides hold only rounding residue; each is held to 2^-7 of the
query bias's gradient norm.
"""

import ast
import contextlib
import ctypes
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from novic_tpu_torch.bridge import harness_params_from_numpy
from novic_tpu_torch.exp import attn_variants as port_av
from novic_tpu_torch.ops import flash_attention as port

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
BLOCK = 128


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as float32 (both sides take the same values)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _segments(kind, B, sq, skv):
    if kind is None:
        return None, None
    if kind == "packed":
        return (np.where(np.arange(n) < n // 3, 1, 2).astype(np.int32)[None].repeat(B, 0)
                for n in (sq, skv))
    seg_q = np.ones((B, sq), np.int32)
    seg_kv = np.ones((B, skv), np.int32)
    if kind in ("padding", "padding_masked_row"):
        seg_q[:, sq - sq // 5:] = 0
        seg_kv[:, skv - skv // 5:] = 0
    if kind in ("masked_row", "padding_masked_row"):
        seg_q[:, 5] = 7  # no key has segment 7
    return seg_q, seg_kv


CASES = [  # (id, hd, sq, skv, segments, causal, ab dtype)
    ("none", 64, 256, 256, None, False, None),
    ("padding", 80, 256, 256, "padding", False, None),
    ("packed", 64, 256, 256, "packed", False, None),
    ("masked_row", 80, 256, 256, "masked_row", False, None),
    ("causal", 64, 256, 256, None, True, None),
    ("ab_f32", 80, 256, 256, None, False, np.float32),
    ("causal_segments_ab", 80, 256, 256, "padding_masked_row", True, np.float32),
    ("sq_ne_skv", 64, 128, 256, "padding", True, jnp.bfloat16),
]


def _jax_case(q, k, v, ab, seg_q, seg_kv, do, causal, scale):
    """o, l, m and the VJP's (dq, dk, dv, dab) of JAX's flash_attention at
    the full BlockSizes of 128, one jitted call (an eager op dispatched while
    the interpreted kernels' callbacks run can deadlock)."""
    bs = jfa.BlockSizes(block_q=BLOCK, block_k_major=BLOCK, block_k=BLOCK, block_b=1,
                        block_q_major_dkv=BLOCK, block_k_major_dkv=BLOCK, block_k_dkv=BLOCK,
                        block_q_dkv=BLOCK, block_k_major_dq=BLOCK, block_k_dq=BLOCK,
                        block_q_dq=BLOCK)
    segs = None if seg_q is None else jfa.SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv))

    def run(q, k, v, ab, do):
        f = lambda q, k, v, ab: jfa.flash_attention(  # noqa: E731
            q, k, v, ab, segs, causal=causal, sm_scale=scale, block_sizes=bs)
        o, vjp = jax.vjp(f, q, k, v, ab)
        _, l, m = jfa._flash_attention(q, k, v, ab, segs, True, causal, scale, bs, False)
        return o, l, m, vjp(do)

    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o, l, m, grads = jax.jit(run)(bf(q), bf(k), bf(v), ab, bf(do))
    f32 = lambda x: None if x is None else np.asarray(x.astype(jnp.float32))  # noqa: E731
    return f32(o), np.asarray(l), np.asarray(m), [f32(g) for g in grads]


def _close(name, got, want, bar):
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    err = np.abs(got - want)
    assert (err <= bar).all(), (name, err.max(), np.unravel_index(np.argmax(err - bar), err.shape))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gradients_match_jax(case):
    """o, l, m, dq, dk, dv and dab of FlashAttentionFn's CPU path against
    JAX's flash_attention and its VJP (bars in the module docstring)."""
    name, hd, sq, skv, seg, causal, ab_dtype = case
    B, H = 1, 2
    rng = np.random.default_rng(hd + sq + skv + len(name))
    q, k, v = (_bf16(rng.normal(size=(B, H, n, hd)).astype(np.float32)) for n in (sq, skv, skv))
    do = _bf16(rng.normal(size=(B, H, sq, hd)).astype(np.float32))
    ab = None
    if ab_dtype is not None:
        ab = rng.normal(size=(B, H, sq, skv)).astype(np.float32)
        if ab_dtype is not np.float32:
            ab = _bf16(ab)
    seg_q, seg_kv = _segments(seg, B, sq, skv)
    scale = 1.0 / np.sqrt(hd)
    jab = None if ab is None else jnp.asarray(ab).astype(ab_dtype)
    o_j, l_j, m_j, (dq_j, dk_j, dv_j, dab_j) = _jax_case(q, k, v, jab, seg_q, seg_kv, do,
                                                         causal, scale)

    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    tab = None
    if ab is not None:
        tab = torch.from_numpy(ab).to(torch.float32 if ab_dtype is np.float32 else torch.bfloat16)
        tab.requires_grad_()
    segs = None if seg_q is None else (torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    out = port.flash_attention(tq, tk, tv, tab, segs, causal=causal, sm_scale=scale,
                               block_k=BLOCK)
    assert isinstance(out.grad_fn, port.FlashAttentionFn._backward_cls)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    o_t, l_t, m_t = port.flash_attention_reference(tq.detach(), tk.detach(), tv.detach(),
                                                   None if tab is None else tab.detach(), segs,
                                                   causal, scale, BLOCK)
    assert torch.equal(o_t, out.detach())

    vmax = np.abs(v).max(axis=2, keepdims=True)
    _close("o", out.detach().float().numpy(), o_j, _ulp(o_j) + 2.0 ** -7 * vmax)
    _close("l", l_t.numpy(), l_j, 1e-5 * np.abs(l_j))
    _close("m", m_t.numpy(), m_j, 1e-5 * np.maximum(np.abs(m_j), 1.0))
    grads = [("dq", tq.grad, dq_j), ("dk", tk.grad, dk_j), ("dv", tv.grad, dv_j)]
    if ab is not None:
        assert tab.grad.dtype == tab.dtype
        grads.append(("dab", tab.grad, dab_j))
    else:
        assert dab_j is None
    for gname, got, want in grads:
        assert got.dtype == (tab.dtype if gname == "dab" else torch.bfloat16), gname
        _close(gname, got.float().numpy(), want, _ulp(want) + 2.0 ** -7 * np.abs(want).max())


def test_no_grad_and_partial_grads():
    """Without grad the output has no grad_fn (the plain forward's residuals
    are dropped); with only ab requiring grad, dab alone is returned; with
    only q, ab gets none."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    ab = torch.from_numpy(rng.normal(size=(1, 2, 64, 64)).astype(np.float32))
    assert port.flash_attention(q, k, v, ab, causal=True).grad_fn is None
    ab.requires_grad_()
    with torch.no_grad():
        assert port.flash_attention(q, k, v, ab).grad_fn is None
    port.flash_attention(q, k, v, ab, causal=True).float().sum().backward()
    assert ab.grad is not None and q.grad is None
    o, l, m = port.flash_attention_reference(q, k, v, ab.detach(), causal=True)
    want = port.flash_attention_bwd_reference(q, k, v, ab.detach(), None, o, l, m,
                                              torch.ones_like(q), causal=True)[3]
    assert torch.equal(ab.grad, want)
    ab2 = ab.detach().clone()
    q.requires_grad_()
    port.flash_attention(q, k, v, ab2).float().sum().backward()
    assert q.grad is not None and ab2.grad is None


# ---- the harness tower ----------------------------------------------------------

KEEP = {"B", "S", "E", "H", "L", "FF", "hd", "bf16", "dense", "ln", "attn_flash", "tower"}
BATCH, E, HEADS, FF = 2, 128, 2, 512


def _load_variants() -> dict:
    """exp/attn_variants.py's imports, shape constants and the definitions
    the tower needs, without the params, the check and the timing at import."""
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
    return ns


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def test_harness_tower_gradient_matches_jax(monkeypatch):
    jav = _load_variants()
    monkeypatch.setattr(port_av, "E", E)
    monkeypatch.setattr(port_av, "H", HEADS)
    jav.update(B=BATCH, E=E, H=HEADS)
    assert jav["hd"] == port_av.hd == E // HEADS  # 64, as in the file
    blocks = jfa.BlockSizes

    def with_backward_blocks(**kw):
        sp = kw["block_q"]
        return blocks(**kw, block_q_major_dkv=sp, block_k_major_dkv=sp, block_k_dkv=sp,
                      block_q_dkv=sp, block_k_major_dq=sp, block_k_dq=sp, block_q_dq=sp)

    monkeypatch.setattr(jfa, "BlockSizes", with_backward_blocks)
    rng = np.random.default_rng(3)

    def mk(*shape, std=0.02, mean=0.0):
        return (mean + rng.normal(0, std, shape)).astype(np.float32)

    params = [dict(n1w=mk(E, mean=1.0), n1b=mk(E), n2w=mk(E, mean=1.0), n2b=mk(E),
                   wq=mk(E, E), bq=mk(E), wk=mk(E, E), bk=mk(E), wv=mk(E, E), bv=mk(E),
                   wo=mk(E, E), bo=mk(E), w1=mk(FF, E), b1=mk(FF), w2=mk(E, FF), b2=mk(E))
              for _ in range(2)]
    x0 = np.random.default_rng(4).normal(size=(BATCH, port_av.S, E)).astype(np.float32)
    cot = np.random.default_rng(5).normal(size=(BATCH, port_av.S, E)).astype(np.float32)

    def loss(x, p, c):
        return jnp.sum(jav["tower"](x, jav["attn_flash"], p).astype(jnp.float32) * c)

    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    with pltpu.force_tpu_interpret_mode():
        gx_j, gp_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x0), jp,
                                                              jnp.asarray(cot))

    tp = harness_params_from_numpy(params)
    for layer in tp:
        for t in layer.values():
            t.requires_grad_()
    x = torch.from_numpy(x0).requires_grad_()
    (port_av.tower(x, port_av.attn_flash, tp).float() * torch.from_numpy(cot)).sum().backward()

    pairs = [("x", x.grad.numpy(), np.asarray(gx_j))]
    pairs += [(f"{i}.{key}", tp[i][key].grad.numpy(), np.asarray(gp_j[i][key]))
              for i in range(len(tp)) for key in tp[i]]
    for name, got, want in pairs:
        assert np.isfinite(got).all(), name
        if name.endswith(".bk"):  # exactly 0: rounding residue on both sides
            bar = 2.0 ** -7 * np.linalg.norm(tp[int(name[0])]["bq"].grad.numpy())
            assert np.linalg.norm(got) <= bar and np.linalg.norm(want) <= bar, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert _cos(got, want) >= 0.9999 and rel <= 1e-2, (name, _cos(got, want), rel)


def test_bf16_dense_grads_match_the_cpu_form():
    """tower_dense's CUDA bf16 GEMM (torch.mm with out_dtype, which autograd
    cannot differentiate) takes `bf16_dense_grads` as its backward: equal to
    autograd through the CPU form `x.to(bf16).float() @ w.to(bf16).float().t()`
    for float32 and bf16 operands, so the harness tower's gradient on the card
    follows the one held against jax.grad above."""
    from novic_tpu_torch.embedders.vit import bf16_dense_grads

    rng = np.random.default_rng(6)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(37, 48)).astype(np.float32)).to(dtype)
        w = torch.from_numpy(rng.normal(size=(24, 48)).astype(np.float32)).requires_grad_()
        x.requires_grad_()
        dy = torch.from_numpy(rng.normal(size=(37, 24)).astype(np.float32))
        (x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t()).backward(dy)
        dx, dw = bf16_dense_grads(dy, x.detach(), w.detach())
        assert dx.dtype == dtype and dw.dtype == torch.float32
        assert torch.equal(dx, x.grad) and torch.equal(dw, w.grad)


# ---- the CUDA wrappers under a recording fake library -----------------------------


class _FakeLibrary:
    """Records each call's arguments (the forward's plan and the backward's
    as the C entries would read them), in order, and returns a CUDA error
    code; the maps entry writes a marker into the buffer it is given."""

    def __init__(self):
        self.err = {"fwd": 0, "maps": 0, "dkv": 0, "dq": 0}
        self.calls = {"fwd": [], "maps": [], "dkv": [], "dq": []}
        self.order, self.plans, self.bwd_plans, self.maps_seen = [], [], [], []

    def _record(self, kind, args):
        self.order.append(kind)
        self.calls[kind].append(args)
        return self.err[kind]

    def novic_flash_attention(self, *args):
        self.plans.append(list((ctypes.c_longlong * 44).from_address(args[9].value)))
        return self._record("fwd", args)

    def novic_flash_attention_bwd_maps(self, *args):
        self.bwd_plans.append(list((ctypes.c_longlong * 66).from_address(args[6].value)))
        ctypes.memset(args[13], 0x5A, 6 * 128)
        return self._record("maps", args)

    def novic_flash_attention_bwd_dkv(self, *args):
        self.maps_seen.append(bytes((ctypes.c_ubyte * 768).from_address(args[0])))
        return self._record("dkv", args)

    def novic_flash_attention_bwd_dq(self, *args):
        self.maps_seen.append(bytes((ctypes.c_ubyte * 768).from_address(args[0])))
        return self._record("dq", args)


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernels' libraries replaced by a recorder, CPU tensors taken down
    the CUDA path, and the plain versions made to fail if reached."""
    lib = _FakeLibrary()
    monkeypatch.setattr(port, "_library", lambda: lib)
    monkeypatch.setattr(port, "_bwd_library", lambda: lib)
    monkeypatch.setattr(port, "_plain", lambda t: False)
    monkeypatch.setattr(port.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def plain(*args, **kwargs):
        raise AssertionError("a kernel launch reached the plain version")

    monkeypatch.setattr(port, "flash_attention_reference", plain)
    monkeypatch.setattr(port, "flash_attention_bwd_reference", plain)
    return lib


class _TorchCalls(torch.overrides.TorchFunctionMode):
    """The names of the torch functions and tensor methods called inside."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def _qkv(B=2, H=3, sq=100, skv=130, hd=80):
    return [torch.zeros((B, H, n, hd), dtype=torch.bfloat16) for n in (sq, skv, skv)]


def test_residuals_only_under_grad(fake_launch):
    """A forward without grad asks for no residuals (l and m null) and
    returns no grad_fn; with an input requiring grad it asks for both, float32
    (B, H, Sq), and returns FlashAttentionFn's output."""
    q, k, v = _qkv()
    launches = port.LAUNCHES
    out = port.flash_attention(q, k, v, causal=True, sm_scale=0.5)
    assert out.grad_fn is None
    (args,) = fake_launch.calls["fwd"]
    assert args[5] is None and args[6] is None
    assert args[11:18] == (2, 3, 100, 130, 80, 0, 1) and args[18] == 0.5
    q.requires_grad_()
    with torch.no_grad():
        port.flash_attention(q, k, v)
    assert fake_launch.calls["fwd"][1][5] is None
    out = port.flash_attention(q, k, v)
    assert isinstance(out.grad_fn, port.FlashAttentionFn._backward_cls)
    args = fake_launch.calls["fwd"][2]
    assert args[5] is not None and args[6] is not None and args[5] != args[6]
    assert port.LAUNCHES == launches + 3
    assert not fake_launch.calls["dkv"] and not fake_launch.calls["dq"]
    assert not fake_launch.calls["maps"]


@pytest.mark.parametrize("ab_dtype", [torch.float32, torch.bfloat16])
def test_backward_launches_both_kernels(fake_launch, ab_dtype):
    """out.backward encodes the backward's tensor maps once (q, k, v, do,
    the forward's o and ab, from `_bwd_plans`), then launches the dQ kernel,
    then the dK/dV kernel, once each: both get the same maps buffer (what
    the maps entry wrote), the same stats buffer (the dQ kernel writes di
    and each row's m and 1/l there, float32 (B, H, Sq padded to 64, 4); the
    dK/dV kernel reads it), the int32 segment ids padded to 64-row tiles,
    the shape, ab's element size, causal and the scale; dQ gets the
    forward's l and m, dq and dab (in ab's dtype). No torch reduction
    computes di. Both are counted, and the gradients come back with their
    inputs' shapes and dtypes."""
    q, k, v = (t.requires_grad_() for t in _qkv())
    ab = torch.zeros((2, 3, 100, 136), dtype=ab_dtype)[..., :130].requires_grad_()
    segs = (torch.ones((2, 100), dtype=torch.int64), torch.ones((2, 130), dtype=torch.int64))
    out = port.flash_attention(q, k, v, ab, segs, causal=True, sm_scale=0.25)
    (fwd,) = fake_launch.calls["fwd"]
    assert fwd[3] == ab.data_ptr() and fwd[11:18] == (2, 3, 100, 130, 80, ab.element_size(), 1)
    assert fake_launch.plans[0][33:] == port._tma_plans(q, k, v, ab)[33:]
    dkv, dq = port.DKV_LAUNCHES, port.DQ_LAUNCHES
    do = torch.zeros((2, 3, 100, 80), dtype=torch.bfloat16)
    calls = _TorchCalls()
    with calls:
        out.backward(do)
    assert fake_launch.order == ["fwd", "maps", "dq", "dkv"]
    (mp,), (a,), (b,) = (fake_launch.calls[kind] for kind in ("maps", "dq", "dkv"))
    assert mp[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), fwd[4],
                      ab.data_ptr())  # o: the forward's output
    assert mp[7:13] == (2, 3, 100, 130, 80, ab.element_size())
    assert fake_launch.bwd_plans == [port._bwd_plans(q, k, v, do, out, ab)]
    maps = mp[13]
    assert a[0] == b[0] == maps and fake_launch.maps_seen == [b"Z" * 768] * 2
    assert a[1:3] == fwd[5:7]  # the forward's l and m
    assert a[3:5] == b[2:4] and None not in a[3:5]  # the segment ids, shared
    assert a[5] == b[1] is not None  # the stats: written by dQ, read by dK/dV
    assert None not in (a[6], a[7], b[4], b[5])  # dq, dab; dk, dv
    assert a[8:15] == b[6:13] == (2, 3, 100, 130, 80, ab.element_size(), 1)
    assert a[15] == b[13] == 0.25
    assert not {"sum", "mul", "__mul__", "einsum", "float"} & set(calls.names), calls.names
    assert (q.grad.shape, k.grad.shape, ab.grad.shape) == (q.shape, k.shape, ab.shape)
    assert q.grad.dtype == torch.bfloat16 and ab.grad.dtype == ab_dtype
    assert (port.DKV_LAUNCHES, port.DQ_LAUNCHES) == (dkv + 1, dq + 1)


def test_bwd_inputs_stats_and_padded_segments(fake_launch):
    """The buffers the two launches share: the stats (B, H, Sq rounded up to
    64, 4) float32 and the segment ids as int32, padded to whole 64-row
    tiles with zeros; the maps are encoded once."""
    q, k, v = _qkv(sq=100, skv=130)
    o = torch.zeros_like(q)
    l, m = torch.ones((2, 3, 100)), torch.zeros((2, 3, 100))
    segs = port.SegmentIds(torch.full((2, 100), 3), torch.full((2, 130), 3))
    a = port._bwd_inputs(q, k, v, None, segs, o, l, m, torch.zeros_like(q), False, 1.0)
    assert a.stats.shape == (2, 3, 128, 4) and a.stats.dtype == torch.float32
    seg_q, seg_kv = a.keep[8:10]
    assert seg_q.dtype == seg_kv.dtype == torch.int32
    assert seg_q.shape == (2, 128) and seg_kv.shape == (2, 192)
    assert (seg_q[:, :100] == 3).all() and (seg_q[:, 100:] == 0).all()
    assert (seg_kv[:, :130] == 3).all() and (seg_kv[:, 130:] == 0).all()
    assert a.pointers == (l.data_ptr(), m.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr())
    assert len(fake_launch.calls["maps"]) == 1 and not fake_launch.calls["dq"]
    assert port.BWD_TILE == 64


def test_no_dab_without_its_grad(fake_launch):
    """An ab that does not require grad is read (its map) but gets no dab
    (null)."""
    q, k, v = (t.requires_grad_() for t in _qkv())
    ab = torch.zeros((2, 3, 100, 136))[..., :130]
    port.flash_attention(q, k, v, ab).backward(torch.zeros((2, 3, 100, 80),
                                                           dtype=torch.bfloat16))
    (mp,), (a,) = fake_launch.calls["maps"], fake_launch.calls["dq"]
    assert mp[5] == ab.data_ptr() and mp[12] == 4
    assert a[7] is None and ab.grad is None


@pytest.mark.parametrize("dtype,rows", [(torch.float32, 128), (torch.bfloat16, 128),
                                        (torch.float32, 192)])
def test_ab_plan(dtype, rows):
    """ab's tensor map: dims (Skv, Sq, H, B), its byte strides of a query,
    a head and a batch, a box of one 128-byte row of keys (32 float32 or 64
    bf16) by the query block (128 where hd <= 64, else 192); a view of a
    wider bias is read in place."""
    hd = 64 if rows == 128 else 80
    q, k, v = _qkv(hd=hd)
    wide = torch.empty((2, 3, 100, 136), dtype=dtype, device="meta")
    es = wide.element_size()
    plan = port._tma_plans(q, k, v, wide[..., :130])
    assert plan[33:] == [130, 100, 3, 2, 136 * es, 100 * 136 * es, 3 * 100 * 136 * es,
                         128 // es, rows, 1, 1]


def _plan(t, n):
    """The expected plan of a (B, H, S, hd) bf16 view: dims (hd, S, H, B), its
    byte strides of a row, a head and a batch, a box of 64 x 64."""
    B, H, _, hd = t.shape
    return [hd, n, H, B, 2 * t.stride(2), 2 * t.stride(1), 2 * t.stride(0), 64, 64, 1, 1]


@pytest.mark.parametrize("case", ["contiguous", "harness_views", "ab_one_batch", "ab_row_slice"])
def test_bwd_plans(case):
    """The backward's maps of q, k, v, do, o and ab, one box shape for both
    kernels: contiguous tensors; the harnesses' (B, H, Sp, hd) views of
    their (B, Sp, H, hd) projections, read in place; an ab of one batch
    (B = 1: its batch stride is never stepped and takes the span inside
    it) and an ab row slice of a wider bias (its strides)."""
    B = 1 if case == "ab_one_batch" else 2
    if case == "harness_views":
        q, k, v, do = (torch.zeros((B, n, 3, 80), dtype=torch.bfloat16).transpose(1, 2)
                       for n in (100, 130, 130, 100))
    else:
        q, k, v = _qkv(B=B)
        do = torch.zeros_like(q)
    o = torch.zeros((B, 3, 100, 80), dtype=torch.bfloat16)
    ab = None
    if case == "ab_one_batch":
        ab = torch.zeros((1, 3, 100, 132))
    elif case == "ab_row_slice":
        ab = torch.zeros((2, 3, 100, 136), dtype=torch.bfloat16)[..., :130]
    plan = port._bwd_plans(q, k, v, do, o, ab)
    want = []
    for t, n in ((q, 100), (k, 130), (v, 130), (do, 100), (o, 100)):
        want += _plan(t, n)
    assert plan[:55] == want
    if case == "harness_views":
        assert plan[4:7] == [3 * 80 * 2, 80 * 2, 100 * 3 * 80 * 2]  # a row, a head, a batch
    if ab is None:
        assert plan[55:] == [0] * 11
    elif case == "ab_one_batch":
        assert plan[55:] == [132, 100, 3, 1, 132 * 4, 100 * 132 * 4, 3 * 100 * 132 * 4,
                             32, 64, 1, 1]
    else:
        assert plan[55:] == [130, 100, 3, 2, 136 * 2, 100 * 136 * 2, 3 * 100 * 136 * 2,
                             64, 64, 1, 1]
    for i, t in enumerate((q, k, v, do, o) + ((ab,) if ab is not None else ())):
        port._check_map("bwd", t, plan[11 * i:11 * (i + 1)])  # raises where a map cannot


def test_do_plan():
    """A cotangent the backward's map can read is read in place: contiguous,
    an aligned (B, S, H, hd) view, a size-1 dimension with any stride; one a
    map cannot take is copied to a contiguous tensor: a seq stride off a
    multiple of 16 bytes, a base off 16 bytes, and a broadcast one (stride
    0, as a map's strides are positive)."""
    do = torch.zeros((2, 3, 100, 80), dtype=torch.bfloat16)
    assert port._bwd_operand(do) is do
    view = torch.zeros((2, 100, 3, 80), dtype=torch.bfloat16).transpose(1, 2)
    assert port._bwd_operand(view) is view
    q, k, v = _qkv()
    assert port._bwd_plans(q, k, v, view, do)[33:44] == [80, 100, 3, 2, 3 * 80 * 2, 80 * 2,
                                                         100 * 3 * 80 * 2, 64, 64, 1, 1]
    one = torch.zeros((1, 3, 100, 80), dtype=torch.bfloat16).as_strided(
        (1, 3, 100, 80), (5, 100 * 80, 80, 1))
    assert port._bwd_operand(one) is one
    broadcast = torch.zeros((1, 1, 1, 80), dtype=torch.bfloat16).expand(2, 3, 100, 80)
    flat = torch.zeros(2 * 3 * 100 * 80 + 8, dtype=torch.bfloat16)
    for odd in (torch.zeros((2, 3, 100, 84), dtype=torch.bfloat16)[..., :80],
                flat[(-flat.data_ptr() // 2) % 8 + 1:][:48000].view(2, 3, 100, 80), broadcast):
        got = port._bwd_operand(odd)
        assert got is not odd and got.is_contiguous() and torch.equal(got, odd)


def test_backward_copies_an_unaligned_cotangent(fake_launch):
    """The cotangent a map cannot take reaches the maps entry as a
    contiguous copy; the launches follow."""
    q, k, v = (t.requires_grad_() for t in _qkv())
    out = port.flash_attention(q, k, v)
    do = torch.zeros((2, 3, 100, 84), dtype=torch.bfloat16)[..., :80]
    out.backward(do)
    (mp,) = fake_launch.calls["maps"]
    assert mp[3] != do.data_ptr()
    assert fake_launch.bwd_plans[0][37:40] == [80 * 2, 100 * 80 * 2, 3 * 100 * 80 * 2]
    assert fake_launch.order == ["fwd", "maps", "dq", "dkv"]


@pytest.mark.parametrize("bad", ["ab_row_stride", "ab_unaligned", "hd_136", "ab_broadcast",
                                 "bwd_q_view"])
def test_refusals_raise_before_any_launch(fake_launch, bad):
    """What a tensor map cannot take is refused before any launch: a float32
    ab whose query stride is not a multiple of 16 bytes (Skv = 6), an ab
    off a 16-byte boundary, an hd above 128, an ab broadcast over the batch
    (stride 0); and, in the backward, a q view no map can read (its maps are
    checked before the maps are encoded or a kernel launched)."""
    q, k, v = _qkv(sq=10, skv=6, hd=136 if bad == "hd_136" else 64)
    ab = None
    if bad == "ab_row_stride":
        ab = torch.zeros((2, 3, 10, 6))
    elif bad == "ab_unaligned":
        ab = torch.zeros(2 * 3 * 10 * 8 + 1)[1:].view(2, 3, 10, 8)[..., :6]
    elif bad == "ab_broadcast":
        ab = torch.zeros((1, 3, 10, 8)).expand(2, 3, 10, 8)
        q, k, v = _qkv(sq=10, skv=8, hd=64)
    if bad == "bwd_q_view":
        q = torch.zeros((2, 3, 10, 68), dtype=torch.bfloat16)[..., :64]
        o, l, m = torch.zeros_like(q), torch.ones((2, 3, 10)), torch.zeros((2, 3, 10))
        with pytest.raises(ValueError):
            port._launch_bwd(q, k, v, None, None, o, l, m, torch.zeros_like(o), False, 1.0,
                             False)
    else:
        with pytest.raises(ValueError):
            port.flash_attention(q, k, v, ab)
    assert not any(fake_launch.calls.values())


@pytest.mark.parametrize("kind", ["maps", "dq", "dkv"])
def test_failed_backward_launch_raises_and_never_falls_back(fake_launch, kind):
    """A backward call the library refuses (a nonzero CUDA error) raises, is
    not counted, stops the backward there (a refused encoding before either
    launch, a refused dQ before dK/dV) and never reaches the plain version."""
    fake_launch.err[kind] = 1
    q, k, v = (t.requires_grad_() for t in _qkv())
    out = port.flash_attention(q, k, v)
    counts = port.DKV_LAUNCHES, port.DQ_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        out.backward(torch.zeros_like(out))
    assert (port.DKV_LAUNCHES, port.DQ_LAUNCHES) == (counts[0], counts[1] + (kind == "dkv"))
    assert fake_launch.order[-1] == kind


def test_bwd_tile_is_the_sources_tile():
    """BWD_TILE, the rows of the backward's boxes and the padding of Sq and
    the segment ids, is the .cu's kTile."""
    src = port.BWD_SOURCE.read_text()
    assert f"constexpr int kTile = {port.BWD_TILE};" in src
