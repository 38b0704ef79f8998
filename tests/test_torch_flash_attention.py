"""Port one-pass attention (novic_tpu_torch.ops.flash_attention, X6) against
JAX's TPU flash-attention kernel (jax.experimental.pallas.ops.tpu
.flash_attention) run in TPU interpret mode on the CPU.

On the CPU the port's wrapper takes the kernel's plain version, which follows
JAX's blocking when given JAX's block_k: multi-step (blocks of 128 over
S=256: online updates with the unnormalised p rounded to bf16) and
single-step (block = S: the normalised p rounded). Inputs are numpy-seeded
bf16, hd 64 and 80, with a padding mask, packed segments, a query row whose
keys are all masked, Sq != Skv, and no segment ids.

Bar: both sides round the same operands to bf16 and sum in float32 in
another order, and exp differs in its last bits, so a p can round one bf16
ulp apart (<= 2^-7 p), which moves an output by at most 2^-7 * max|v| over
the keys; the bf16 output itself may then round one ulp apart. Each element
is held to one bf16 ulp of the JAX output plus 2^-7 * max|v|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds as JSegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from novic_tpu_torch.ops import flash_attention as port

torch.set_num_threads(2)


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _inputs(seed, B, H, sq, skv, hd, seg):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, n, hd)).astype(np.float32) for n in (sq, skv, skv))
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    q, k, v = bf(q), bf(k), bf(v)
    seg_q = seg_kv = None
    if seg == "padding":
        seg_q = np.zeros((B, sq), np.int32)
        seg_q[:, : sq - sq // 5] = 1
        seg_kv = np.zeros((B, skv), np.int32)
        seg_kv[:, : skv - skv // 5] = 1
    elif seg == "packed":
        seg_q = np.where(np.arange(sq) < sq // 3, 1, 2).astype(np.int32)[None].repeat(B, 0)
        seg_kv = np.where(np.arange(skv) < skv // 3, 1, 2).astype(np.int32)[None].repeat(B, 0)
    elif seg == "masked_row":
        seg_q = np.ones((B, sq), np.int32)
        seg_q[:, 5] = 7  # no key has segment 7
        seg_kv = np.ones((B, skv), np.int32)
    return q, k, v, seg_q, seg_kv


def _jax(q, k, v, seg_q, seg_kv, scale, block):
    f = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    segs = None if seg_q is None else JSegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv))
    bs = BlockSizes(block_q=min(block, q.shape[2]), block_k_major=block, block_k=block, block_b=1)
    with pltpu.force_tpu_interpret_mode():
        out = jax_flash(f(q), f(k), f(v), segment_ids=segs, sm_scale=scale, block_sizes=bs)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


CASES = [  # (hd, sq, skv, block, segments)
    (64, 256, 256, 128, "padding"),
    (80, 256, 256, 128, "padding"),
    (64, 256, 256, 256, "padding"),
    (80, 256, 256, 256, "padding"),
    (80, 256, 256, 128, "packed"),
    (64, 256, 256, 256, "packed"),
    (64, 256, 256, 128, "masked_row"),
    (80, 256, 256, 256, "masked_row"),
    (64, 128, 256, 128, "padding"),
    (80, 256, 256, 128, None),
]


@pytest.mark.parametrize("hd,sq,skv,block,seg", CASES,
                         ids=[f"hd{c[0]}-q{c[1]}-kv{c[2]}-b{c[3]}-{c[4]}" for c in CASES])
def test_plain_version_matches_jax_flash_attention(hd, sq, skv, block, seg):
    q, k, v, seg_q, seg_kv = _inputs(hd + sq + block, 1, 2, sq, skv, hd, seg)
    scale = 1.0 / np.sqrt(hd)
    ref = _jax(q, k, v, seg_q, seg_kv, scale, block)
    segs = None if seg_q is None else port.SegmentIds(torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    out = port.flash_attention(q, k, v, segment_ids=segs, sm_scale=scale, block_k=block)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, sq, hd)
    out = out.float().numpy()
    vmax = v.float().abs().amax(dim=2, keepdim=True).numpy()  # over keys
    bar = _ulp(ref) + 2.0 ** -7 * vmax
    assert np.isfinite(out).all()
    assert (np.abs(out - ref) <= bar).all(), np.abs(out - ref).max()
    if seg == "masked_row":  # every key masked: the plain mean of v, as JAX gives
        mean = v.float().mean(dim=2).numpy()
        assert np.abs(out[:, :, 5] - mean).max() <= 2.0 ** -7 * vmax[:, :, 0].max() + 2e-2


def test_kernel_blocking_against_jax_blockings():
    """The kernel's blocking (64-key online updates, default block_k) against
    the single-step and 128-key blockings: every element moves by at most the
    rounding of each p (2^-8 relative wherever it is taken), 2^-8 * max|v|,
    plus one bf16 ulp of the output."""
    q, k, v, seg_q, seg_kv = _inputs(3, 2, 3, 200, 192, 80, "padding")
    segs = port.SegmentIds(torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    own = port.flash_attention(q, k, v, segment_ids=segs, sm_scale=0.1).float()
    plain = port.flash_attention_reference(q, k, v, segment_ids=segs, sm_scale=0.1)[0]
    assert torch.equal(own, plain.float())
    vmax = v.float().abs().amax(dim=2, keepdim=True)
    for block in (128, 192):
        other = port.flash_attention_reference(q, k, v, segment_ids=segs, sm_scale=0.1,
                                               block_k=block)[0].float()
        bar = torch.from_numpy(_ulp(other.numpy())) + 2.0 ** -8 * vmax + 1e-6
        assert ((own - other).abs() <= bar).all(), block


def test_strided_views_and_one_key():
    """(B, S, H, hd) projections read as (B, H, S, hd) views; S = 1."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 1, 3, 16)).astype(np.float32)).to(torch.bfloat16)
    out = port.flash_attention(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    torch.testing.assert_close(out.float(), x.transpose(1, 2).float(), rtol=0, atol=0)
    q, k, v, seg_q, seg_kv = _inputs(5, 2, 3, 100, 100, 64, "packed")
    segs = (torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(port.flash_attention(*views, segment_ids=segs),
                       port.flash_attention(q, k, v, segment_ids=segs))


def test_wrapper_checks():
    """causal and ab are taken (held against JAX in
    tests/test_torch_flash_attention_bwd.py); an ab of another shape or
    dtype, or whose keys are not contiguous, is refused."""
    q = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    assert port.flash_attention(q, q, q, causal=True).shape == q.shape
    assert port.flash_attention(q, q, q, ab=torch.zeros((1, 2, 8, 8))).shape == q.shape
    for bad in (torch.zeros((1, 2, 8, 7)), torch.zeros((1, 2, 8, 8), dtype=torch.float16),
                torch.zeros((1, 2, 8, 8)).transpose(2, 3)):
        with pytest.raises(ValueError, match="ab must be"):
            port.flash_attention(q, q, q, ab=bad)
    with pytest.raises(ValueError, match="bfloat16"):
        port.flash_attention(q.float(), q, q)
    with pytest.raises(ValueError, match="k and v"):
        port.flash_attention(q, q[:, :1], q)
    with pytest.raises(ValueError, match="segment_ids.kv"):
        seg = torch.ones((1, 8), dtype=torch.int32)
        port.flash_attention(q, q, q, segment_ids=(seg, seg[:, :4]))


def test_kernel_block_k_is_the_sources_update_tile():
    """KERNEL_BLOCK_K, the plain version's default blocking, is the key tile
    over which csrc/flash_attention.cu updates the softmax online."""
    import re

    text = port.SOURCE.read_text()
    (tile,) = re.findall(r"constexpr int kKTile = (\d+);", text)
    assert int(tile) == port.KERNEL_BLOCK_K


def _harness_views(B, S, H, hd):
    """(B, S, H, hd) projections read as (B, H, S, hd) views, as the
    harnesses' flash preps hand them over."""
    return [torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="meta").transpose(1, 2)
            for _ in range(3)]


@pytest.mark.parametrize("case", ["dfn5b", "attn_variants", "sq_ne_skv", "one_key"])
def test_x6_tma_plan(case):
    """Each (B, H, S, hd) view is read in place through a 4-D map: dims (hd,
    S, H, B), the view's byte strides of seq, head and batch (a size-1 seq is
    never stepped and gets the span of a row), a box of one 64-wide atom by
    the query block (128 rows where hd <= 64, else 192) for q and by the
    64-key tile for k and v."""
    if case in ("dfn5b", "attn_variants"):  # the harnesses' padded projections
        B, S, H, hd = (32, 768, 16, 80) if case == "dfn5b" else (256, 256, 12, 64)
        q, k, v = _harness_views(B, S, H, hd)
        seq = [H * hd * 2, hd * 2, S * H * hd * 2]  # seq, head, batch strides in bytes
        want = [[hd, S, H, B] + seq] * 3
    elif case == "sq_ne_skv":  # contiguous (B, H, S, hd): Sq 70, Skv 200
        B, H, hd = 2, 3, 80
        q, k, v = (torch.empty(B, H, n, hd, dtype=torch.bfloat16, device="meta")
                   for n in (70, 200, 200))
        want = [[hd, n, H, B, hd * 2, n * hd * 2, H * n * hd * 2] for n in (70, 200, 200)]
    else:  # one query and one key, read from the (B, 1, H, hd) projections
        B, H, hd = 2, 3, 64
        q, k, v = _harness_views(B, 1, H, hd)
        want = [[hd, 1, H, B, hd * 2, hd * 2, H * hd * 2]] * 3
    rows = (128 if hd <= 64 else 192, 64, 64)
    plan = port._tma_plans(q, k, v)
    assert plan == sum((w + [64, r, 1, 1] for w, r in zip(want, rows)), []) + [0] * 11


class _FakeLibrary:
    """Records each launch's arguments, the plan and the output strides they
    point at and the key segment ids as the kernel would read them, and
    returns a CUDA error code."""

    def __init__(self, err: int = 0):
        self.err, self.calls, self.plans, self.kv_seg = err, [], [], []

    def novic_flash_attention(self, *args):
        import ctypes

        self.calls.append(args)
        self.plans.append(list((ctypes.c_longlong * 44).from_address(args[9].value)))
        B, skv = args[11], args[14]
        if args[8] is not None:
            n = B * (-(-skv // port.KERNEL_BLOCK_K) * port.KERNEL_BLOCK_K)
            self.kv_seg.append(list((ctypes.c_int * n).from_address(args[8])))
        return self.err


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernel's library replaced by a recorder, CPU tensors standing in
    for CUDA ones, and the plain version made to fail if reached."""
    import contextlib
    import types

    lib = _FakeLibrary()
    monkeypatch.setattr(port, "_library", lambda: lib)
    monkeypatch.setattr(port.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def plain(*args):
        raise AssertionError("a kernel launch reached the plain version")

    monkeypatch.setattr(port, "flash_attention_reference", plain)
    return lib


def _projections(B, S, H, hd, offset: int = 0, pad: int = 0):
    """A (B, S, H, hd) bf16 projection, rows hd + pad apart, its base `offset`
    elements past a 16-byte boundary, read as a (B, H, S, hd) view."""
    n = B * S * H * (hd + pad)
    flat = torch.zeros(n + 16, dtype=torch.bfloat16)
    start = (-flat.data_ptr() // 2) % 8 + offset
    x = flat[start:start + n].view(B, S, H, hd + pad)[..., :hd]
    return x.transpose(1, 2)


@pytest.mark.parametrize("hd,sq,skv,seg", [(80, 768, 768, True), (64, 256, 256, True),
                                           (80, 70, 200, True), (8, 1, 1, False),
                                           (128, 100, 100, False)])
def test_x6_instance_every_view_launches_the_wgmma_kernel(fake_launch, hd, sq, skv, seg):
    """X6 has one instance, the TMA + wgmma kernel: every view the wrapper
    takes launches it once, with the views' maps, a contiguous (B, H, Sq, hd)
    bf16 output and its strides, and the key segment ids padded to whole
    64-key tiles; the launch is counted."""
    B, H = 2, 3
    q, k, v = _projections(B, sq, H, hd), _projections(B, skv, H, hd), _projections(B, skv, H, hd)
    segs = None
    if seg:
        segs = port.SegmentIds(torch.ones(B, sq, dtype=torch.int32),
                               torch.arange(B * skv, dtype=torch.int32).view(B, skv))
    launches = port.LAUNCHES
    # as flash_attention does for CUDA tensors without grad: no residuals
    out, l, m = port._launch(q, k, v, None, segs, False, 0.125)
    assert l is None and m is None
    assert out.shape == (B, H, sq, hd) and out.dtype == torch.bfloat16 and out.is_contiguous()
    (args,) = fake_launch.calls
    assert args[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), None, None)
    assert fake_launch.plans == [port._tma_plans(q, k, v)]
    assert args[11:18] == (B, H, sq, skv, hd, 0, 0) and args[18] == 0.125
    import ctypes

    assert list((ctypes.c_longlong * 3).from_address(args[10].value)) == list(out.stride()[:3])
    if seg:
        pad = -skv % port.KERNEL_BLOCK_K
        (kv,) = fake_launch.kv_seg
        want = torch.nn.functional.pad(segs.kv, (0, pad)).flatten().tolist()
        assert kv == want
    else:
        assert args[7] is None and args[8] is None
    assert port.LAUNCHES == launches + 1


@pytest.mark.parametrize("bad", ["unaligned", "row_stride", "hd12", "hd136"])
def test_x6_refuses_what_a_tensor_map_cannot_take(fake_launch, bad):
    """A view a tensor map cannot take (a base off a 16-byte boundary, a
    stride that is not a multiple of 16 bytes) and an hd that is not a
    multiple of 8 or is above 128 are refused before any launch."""
    hd = {"hd12": 12, "hd136": 136}.get(bad, 64)
    q = _projections(2, 10, 3, hd, offset=1 if bad == "unaligned" else 0,
                     pad=4 if bad == "row_stride" else 0)
    k = v = _projections(2, 10, 3, hd)
    with pytest.raises(ValueError):
        port._launch(q, k, v, None, None, False, 1.0)
    assert not fake_launch.calls


def test_x6_refused_launch_raises_and_never_falls_back(fake_launch):
    """A launch the kernel refuses (a nonzero CUDA error) raises, counts
    nothing and never reaches the plain version."""
    fake_launch.err = 1
    q = _projections(2, 10, 3, 64)
    launches = port.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        port._launch(q, q, q, None, None, False, 1.0)
    assert port.LAUNCHES == launches
