"""One-pass attention with segment ids, a causal mask and an additive bias (X6),
and its backward (X6b): the hand-written CUDA kernels that take the place of
JAX's TPU flash-attention kernels (jax.experimental.pallas.ops.tpu
.flash_attention: the forward, which the exp/ harnesses' `make_attn_flash`
and `attn_flash` call, and the dK/dV and dQ kernels of its custom VJP), and
their plain versions.

`flash_attention(q, k, v, ab=None, segment_ids=None, *, causal=False,
sm_scale=1.0)` computes what JAX's `flash_attention` computes, forward and
backward: q (B, H, Sq, hd), k and v (B, H, Skv, hd) bf16;
s = (q·kᵀ + ab) · sm_scale in float32 (the bias added before the scale, as
JAX adds it); where the segment ids of a query and a key differ, or (causal)
the key lies after the query, s gets MASK_VALUE (-0.7 * float32 max) added
once (finite, so a query whose keys are all masked gets the mean of v);
softmax online over key blocks with the unnormalised p rounded to bf16
before its product with v; the result in bf16, (B, H, Sq, hd). Under
`causal`, key blocks wholly above the diagonal are never visited, as JAX's
`below_or_on_diag` skips them: key j takes part in row i only where
(j // 128) * 128 < (i // 128 + 1) * 128 - 1, i.e. j // 128 <= i // 128, which
is JAX's rule at its default blocks of 128 (`CAUSAL_BLOCK`). Only a row whose
visited keys are all masked sees the difference.

It is a `torch.autograd.Function` (`FlashAttentionFn`) when an input
requires grad: the forward then also writes the softmax residuals l and m
(float32 (B, H, Sq): m the row max, l the sum of exp(s - m)), and the
backward follows `_flash_attention_bwd`: di = Σ o·do, p = exp(s - m) · (1/l),
dv = bf16(p)ᵀ·do, dp = do·vᵀ, ds = (dp - di)·p·sm_scale, dk = bf16(ds)ᵀ·q,
dq = bf16(ds)·k, d`ab` = ds in ab's dtype. Without grad no residual is
written.

* On CPU tensors both directions run the plain versions,
  `flash_attention_reference` (in JAX's blocking: online updates over
  `block_k` keys in JAX's order of operations, or JAX's single-step body
  when block_k is the kv length; block_k defaults to the kernel's own
  blocking) and `flash_attention_bwd_reference`.
* On CUDA tensors they launch the kernels or raise: the forward in
  csrc/flash_attention.cu (its online-update block is always its 64-key
  tile, so block_k sets only the plain version's blocking), the backward's
  dQ kernel (which also computes di and hands it, with each row's m and
  1/l, to the next kernel) and then its dK/dV kernel, in
  csrc/flash_attention_bwd.cu. They never fall back to the plain versions.

q, k and v may be strided (batch, head, seq) views with hd contiguous; the
kernels read them, and ab (float32 or bf16 (B, H, Sq, Skv), its keys
contiguous), in place through tensor maps (TMA): the forward's laid out by
`_tma_plans`, the backward's by `_bwd_plans` and encoded once a backward
for both of its kernels. A view a map cannot take (a base or a stride that
is not a multiple of 16 bytes) is refused before any launch; a cotangent
`do` a map cannot take is copied to a contiguous tensor first
(`_bwd_operand`). The kernels are compiled with nvcc for sm_90a at first
use into build/novic_tpu_torch/ and loaded through ctypes. `LAUNCHES`,
`DKV_LAUNCHES` and `DQ_LAUNCHES` count the forward's, the dK/dV kernel's
and the dQ kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from novic_tpu_torch.ops import build as _build
from novic_tpu_torch.ops.attention_bf16 import _check_map, _tma_plan, q_rows

LAUNCHES = 0      # forward kernel launches since import (or since a caller reset it)
DKV_LAUNCHES = 0  # dK/dV kernel launches
DQ_LAUNCHES = 0   # dQ kernel launches

SOURCE = _build.CSRC / "flash_attention.cu"
BWD_SOURCE = _build.CSRC / "flash_attention_bwd.cu"
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # flash_attention.py DEFAULT_MASK_VALUE
KERNEL_BLOCK_K = 64  # the kernel's key tile, over which it updates the softmax online
CAUSAL_BLOCK = 128   # JAX's default block_q and block_k_major: the causal skip's blocks
MAX_HD = 128  # the largest hd the kernels take (a multiple of 8)
BWD_TILE = 64  # the backward's tiles: rows of every map's box; Sq and the segment ids pad to it
_AB_DTYPES = (torch.float32, torch.bfloat16)
_library = _build.Library(SOURCE, {"novic_flash_attention": (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
    ctypes.c_int)})
_bwd_library = _build.Library(BWD_SOURCE, {
    "novic_flash_attention_bwd_maps": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int),
    "novic_flash_attention_bwd_dq": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "novic_flash_attention_bwd_dkv": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int)})


class SegmentIds(NamedTuple):
    """Segment ids of the queries (B, Sq) and of the keys (B, Skv): a query
    attends only to keys of its own segment."""
    q: torch.Tensor
    kv: torch.Tensor


def _causal_skipped(sq: int, skv: int, block_k: int, device: torch.device) -> torch.Tensor:
    """(Sq, Skv) bool: the keys a causal run never visits for a row, those of
    the key blocks JAX's `below_or_on_diag(r, CAUSAL_BLOCK, c, block_k)` skips
    for the row's query block r (c * block_k >= (r + 1) * CAUSAL_BLOCK - 1)."""
    r = torch.arange(sq, device=device) // CAUSAL_BLOCK
    c = torch.arange(skv, device=device) // block_k
    return c[None, :] * block_k >= (r[:, None] + 1) * CAUSAL_BLOCK - 1


def _scores(q, k, ab, segment_ids: Optional[SegmentIds], causal: bool, sm_scale: float,
            skipped: Optional[torch.Tensor]) -> torch.Tensor:
    """float32 (B, H, Sq, Skv) scores in JAX's order: q·kᵀ, + ab, · sm_scale,
    + MASK_VALUE once where a segment or the causal mask masks; the keys a
    causal run never visits (`skipped`) get -inf, so their p is 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if ab is not None:
        s = s + ab.float()
    s = s * sm_scale
    keep = None
    if segment_ids is not None:
        keep = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, :]
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        below = (torch.arange(skv, device=s.device)[None, :]
                 <= torch.arange(sq, device=s.device)[:, None])
        keep = below if keep is None else keep & below
    if keep is not None:
        s = s + torch.where(keep, 0.0, MASK_VALUE)
    if skipped is not None:
        s = s.masked_fill(skipped, -torch.inf)
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              ab: Optional[torch.Tensor] = None,
                              segment_ids: Optional[SegmentIds] = None, causal: bool = False,
                              sm_scale: float = 1.0, block_k: Optional[int] = None
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (o (B, H, Sq, hd) bf16, l, m (B, H, Sq) float32), in
    JAX's blocking and order of operations: per block of block_k keys (the
    last one may be shorter) the online update of
    `_flash_attention_kernel_single_batch`, with the accumulator kept
    normalised; when block_k is the kv length, the single-step body. block_k
    None is the kernel's blocking: online updates over 64 keys, also when
    there are 64 keys or fewer. Under `causal` a row skips the key blocks of
    JAX's `below_or_on_diag` at query blocks of CAUSAL_BLOCK and key blocks
    of block_k (CAUSAL_BLOCK where block_k is None, as the kernel does: JAX's
    default blocks); a skipped block leaves the row's
    state untouched. m is the running max, l the sum of exp(s - m) at the
    final m. bf16 operands are held in float32, whose products of bf16 values
    are exact."""
    skv = k.shape[2]
    if segment_ids is not None:
        segment_ids = SegmentIds(*segment_ids)
    single_step = block_k == skv
    skipped = None
    if causal:
        skipped = _causal_skipped(q.shape[2], skv, block_k or CAUSAL_BLOCK, q.device)
    block_k = KERNEL_BLOCK_K if block_k is None else block_k
    s = _scores(q, k, ab, segment_ids, causal, sm_scale, skipped)
    vf = v.float()
    if single_step:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf)
        return o.to(q.dtype), l[..., 0], m[..., 0]
    m = torch.full(s.shape[:-1] + (1,), -torch.inf, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=s.device)
    for k0 in range(0, skv, block_k):
        sb = s[..., k0:k0 + block_k]
        m_next = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc_next = acc * (l_corr * inv)
        o_curr = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                              vf[:, :, k0:k0 + block_k])
        acc_next = acc_next + o_curr * inv
        if skipped is None:
            m, l, acc = m_next, l_next, acc_next
        else:  # rows whose query block skips this key block keep their state
            run = ~skipped[:, k0][:, None]
            m, l = torch.where(run, m_next, m), torch.where(run, l_next, l)
            acc = torch.where(run, acc_next, acc)
    return acc.to(q.dtype), l[..., 0], m[..., 0]


def flash_attention_bwd_reference(q, k, v, ab, segment_ids, o, l, m, do, causal: bool = False,
                                  sm_scale: float = 1.0, block_k: int = CAUSAL_BLOCK):
    """Plain backward, (dq, dk, dv, dab), after `_flash_attention_bwd`: di =
    Σ o·do in float32; p = exp(s - m) · (1/l) from the forward's residuals;
    dv = bf16(p)ᵀ·do; dp = do·vᵀ; ds = (dp - di)·p·sm_scale; dk = bf16(ds)ᵀ·q;
    dq = bf16(ds)·k; dab = ds in ab's dtype (None without ab). Under `causal`
    the keys of the blocks `below_or_on_diag` skips (query blocks of
    CAUSAL_BLOCK, key blocks of block_k) get p = 0, so ds = 0 there. dq, dk
    and dv in q, k and v's dtypes."""
    if segment_ids is not None:
        segment_ids = SegmentIds(*segment_ids)
    skipped = None
    if causal:
        skipped = _causal_skipped(q.shape[2], k.shape[2], block_k, q.device)
    s = _scores(q, k, ab, segment_ids, causal, sm_scale, skipped)
    p = torch.exp(s - m[..., None].float()) * (1.0 / l[..., None].float())
    dof = do.float()
    di = (o.float() * dof).sum(dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(torch.bfloat16).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = (dp - di[..., None]) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    dsb = ds.to(torch.bfloat16).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, k.float())
    dab = None if ab is None else ds.to(ab.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dab


def _check(q, k, v, ab, segment_ids: Optional[SegmentIds]) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be (B, H, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, sq, hd = q.shape
    skv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k and v must be ({B}, {H}, Skv, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bfloat16 on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous along hd")
    if ab is not None and (tuple(ab.shape) != (B, H, sq, skv) or ab.dtype not in _AB_DTYPES
                           or ab.device != q.device or ab.stride(-1) != 1):
        raise ValueError(f"flash_attention: ab must be float32 or bfloat16 ({B}, {H}, {sq}, "
                         f"{skv}) on {q.device}, contiguous along the keys, got {ab.dtype} "
                         f"{tuple(ab.shape)} strides {ab.stride()} on {ab.device}")
    if segment_ids is not None:
        for name, t, n in (("q", segment_ids.q, sq), ("kv", segment_ids.kv, skv)):
            if tuple(t.shape) != (B, n) or t.dtype.is_floating_point or t.device != q.device:
                raise ValueError(f"flash_attention: segment_ids.{name} must be integer ({B}, {n}) "
                                 f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _tma_plans(q, k, v, ab=None) -> list[int]:
    """The forward kernel's tensor maps of q, k, v and ab, 11 values each:
    every (B, H, S, hd) view is read as its (B, S, H, hd) transpose through
    `attention_bf16._tma_plan`, dims (hd, S, H, B) with the view's byte
    strides, a box of one 64-wide atom by the query block (q) or the 64-key
    tile (k, v). The harnesses' (B, H, Sp, hd) views of their (B, Sp, H, hd)
    projections are so read in place. ab (B, H, Sq, Skv) the same way, dims
    (Skv, Sq, H, B), a box of one 128-byte row of keys (32 float32 or 64
    bf16) by the query block; eleven zeros without ab."""
    hd = q.shape[-1]
    plan = []
    for t, rows in ((q, q_rows(hd)), (k, KERNEL_BLOCK_K), (v, KERNEL_BLOCK_K)):
        plan += _tma_plan(t.transpose(1, 2), t.shape[2], rows)
    if ab is None:
        return plan + [0] * 11
    ab_plan = _tma_plan(ab.transpose(1, 2), ab.shape[2], q_rows(hd))
    ab_plan[7] = 128 // ab.element_size()
    return plan + ab_plan


def _segments(segment_ids: Optional[SegmentIds], pad_kv: int = 0):
    """int32 contiguous (q, kv) segment ids, the key ids padded by pad_kv."""
    if segment_ids is None:
        return None, None
    seg_q, seg_kv = (t.to(torch.int32).contiguous() for t in segment_ids)
    return seg_q, F.pad(seg_kv, (0, pad_kv)) if pad_kv else seg_kv


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, ab, segment_ids: Optional[SegmentIds], causal: bool, sm_scale: float,
            residuals: bool = False):
    """The forward kernel: (o, l, m), l and m float32 (B, H, Sq) when
    `residuals`, else None."""
    global LAUNCHES
    B, H, sq, hd = q.shape
    skv = k.shape[2]
    if hd % 8 or hd > MAX_HD:
        raise ValueError(f"flash_attention: unsupported hd={hd} (a multiple of 8, at most {MAX_HD})")
    plan = _tma_plans(q, k, v, ab)
    for i, (name, t) in enumerate((("q", q), ("k", k), ("v", v), ("ab", ab))):
        if t is not None:
            _check_map(f"flash_attention: {name}", t, plan[11 * i:11 * (i + 1)])
    # The kernel reads the key ids a 64-key tile at a time: pad to whole tiles
    seg_q, seg_kv = _segments(segment_ids, -skv % KERNEL_BLOCK_K)
    lib = _library()
    out = torch.empty((B, H, sq, hd), dtype=torch.bfloat16, device=q.device)
    l = m = None
    if residuals:
        l, m = (torch.empty((B, H, sq), dtype=torch.float32, device=q.device) for _ in range(2))
    ab_bytes = 0 if ab is None else ab.element_size()
    _build.launch("flash_attention", q.device, lambda stream: lib.novic_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ab), out.data_ptr(), _ptr(l), _ptr(m),
        _ptr(seg_q), _ptr(seg_kv), _build.longs(plan), _build.longs(out.stride()[:3]),
        B, H, sq, skv, hd, ab_bytes, int(causal), sm_scale, stream))
    LAUNCHES += 1
    return out, l, m


def _bwd_plans(q, k, v, do, o, ab=None) -> list[int]:
    """The backward kernels' tensor maps of q, k, v, do, o and ab, 11 values
    each: every (B, H, S, hd) view read as its (B, S, H, hd) transpose
    through `attention_bf16._tma_plan`, dims (hd, S, H, B) with the view's
    byte strides and a box of one 64-wide atom by BWD_TILE rows; ab (B, H,
    Sq, Skv) the same way, dims (Skv, Sq, H, B), a box of one 128-byte row of
    keys (32 float32 or 64 bf16) by BWD_TILE queries; eleven zeros without
    ab. Both kernels read every map through these boxes, so one encoding
    serves both."""
    plan = []
    for t in (q, k, v, do, o):
        plan += _tma_plan(t.transpose(1, 2), t.shape[2], BWD_TILE)
    if ab is None:
        return plan + [0] * 11
    ab_plan = _tma_plan(ab.transpose(1, 2), ab.shape[2], BWD_TILE)
    ab_plan[7] = 128 // ab.element_size()
    return plan + ab_plan


def _bwd_operand(t: torch.Tensor) -> torch.Tensor:
    """The cotangent as the backward's map reads it: in place where a map
    can take it (a 16-byte aligned base, hd contiguous, byte strides that
    are positive multiples of 16; a size-1 dimension is never stepped), else
    a contiguous copy (a broadcast cotangent, stride 0, is copied too)."""
    if t.stride(-1) == 1:
        try:
            _check_map("", t, _tma_plan(t.transpose(1, 2), t.shape[2], BWD_TILE))
            return t
        except ValueError:
            pass
    return t.contiguous() if not t.is_contiguous() else t.clone()


def _padded(n: int) -> int:
    return -(-n // BWD_TILE) * BWD_TILE


class BwdInputs(NamedTuple):
    """What both backward kernels read, prepared once: the tensor maps,
    encoded once and passed to both launches; the row stats the dQ kernel
    writes and the dK/dV kernel reads; the launch arguments around them;
    what the wrappers allocate from."""
    maps: ctypes.Array  # q, k, v, do, o, ab: 6 encoded tensor maps of 128 bytes
    stats: torch.Tensor  # (B, H, Sq_pad, 4) float32: m, 1/l, di, 0 a query row
    pointers: tuple  # l, m, q_seg, kv_seg (the segment ids padded to BWD_TILE)
    shape: tuple  # B, H, Sq, Skv, hd, ab's element size, causal, sm_scale
    keep: tuple  # the tensors the maps and pointers point at, alive until the launches
    device: torch.device
    ab_dtype: Optional[torch.dtype]


def _bwd_inputs(q, k, v, ab, segment_ids: Optional[SegmentIds], o, l, m, do, causal: bool,
                sm_scale: float) -> BwdInputs:
    """The backward kernels' inputs: do as a map reads it, the maps of q, k,
    v, do, o and ab encoded once, the segment ids as int32 padded to whole
    BWD_TILE rows, and the stats buffer (m, 1/l and di a row: di = Σ o·do is
    the dQ kernel's, as no torch reduction computes it). A view a map cannot
    take raises here, before any launch."""
    B, H, sq, hd = q.shape
    skv = k.shape[2]
    if hd % 8 or hd > MAX_HD:
        raise ValueError(f"flash_attention backward: unsupported hd={hd} (a multiple of 8, at "
                         f"most {MAX_HD})")
    do = _bwd_operand(do)
    plan = _bwd_plans(q, k, v, do, o, ab)
    for i, (name, t) in enumerate((("q", q), ("k", k), ("v", v), ("do", do), ("o", o),
                                   ("ab", ab))):
        if t is not None:
            _check_map(f"flash_attention backward: {name}", t, plan[11 * i:11 * (i + 1)])
    seg_q, seg_kv = _segments(segment_ids)
    if seg_q is not None:
        seg_q = F.pad(seg_q, (0, _padded(sq) - sq))
        seg_kv = F.pad(seg_kv, (0, _padded(skv) - skv))
    stats = torch.empty((B, H, _padded(sq), 4), dtype=torch.float32, device=q.device)
    ab_bytes = 0 if ab is None else ab.element_size()
    maps = (ctypes.c_ubyte * (6 * 128))()
    err = _bwd_library().novic_flash_attention_bwd_maps(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), _ptr(ab),
        _build.longs(plan), B, H, sq, skv, hd, ab_bytes, ctypes.addressof(maps))
    if err != 0:
        raise RuntimeError(f"flash_attention backward: tensor maps refused: CUDA error {err}")
    keep = (q, k, v, do, o, ab, l, m, seg_q, seg_kv)
    return BwdInputs(maps, stats, (_ptr(l), _ptr(m), _ptr(seg_q), _ptr(seg_kv)),
                     (B, H, sq, skv, hd, ab_bytes, int(causal), sm_scale), keep, q.device,
                     None if ab is None else ab.dtype)


def _launch_dq(a: BwdInputs, need_dab: bool):
    """The dQ kernel, launched first: (dq bf16 (B, H, Sq, hd), dab (B, H, Sq,
    Skv) in ab's dtype where need_dab, else None); it fills a.stats."""
    global DQ_LAUNCHES
    B, H, sq, skv, hd = a.shape[:5]
    lib = _bwd_library()
    dq = torch.empty((B, H, sq, hd), dtype=torch.bfloat16, device=a.device)
    dab = torch.empty((B, H, sq, skv), dtype=a.ab_dtype, device=a.device) if need_dab else None
    _build.launch("flash_attention dQ", a.device, lambda stream: lib.novic_flash_attention_bwd_dq(
        ctypes.addressof(a.maps), *a.pointers, a.stats.data_ptr(), dq.data_ptr(), _ptr(dab),
        *a.shape, stream))
    DQ_LAUNCHES += 1
    return dq, dab


def _launch_dkv(a: BwdInputs):
    """The dK/dV kernel, launched after the dQ kernel (it reads the stats
    that one writes): (dk, dv), bf16 (B, H, Skv, hd)."""
    global DKV_LAUNCHES
    B, H, _, skv, hd = a.shape[:5]
    lib = _bwd_library()
    dk = torch.empty((B, H, skv, hd), dtype=torch.bfloat16, device=a.device)
    dv = torch.empty_like(dk)
    _build.launch("flash_attention dK/dV", a.device,
                  lambda stream: lib.novic_flash_attention_bwd_dkv(
                      ctypes.addressof(a.maps), a.stats.data_ptr(), *a.pointers[2:],
                      dk.data_ptr(), dv.data_ptr(), *a.shape, stream))
    DKV_LAUNCHES += 1
    return dk, dv


def _launch_bwd(q, k, v, ab, segment_ids: Optional[SegmentIds], o, l, m, do, causal: bool,
                sm_scale: float, need_dab: bool):
    """The backward kernels, dQ then dK/dV: (dq, dk, dv, dab), dab None
    unless need_dab."""
    a = _bwd_inputs(q, k, v, ab, segment_ids, o, l, m, do, causal, sm_scale)
    dq, dab = _launch_dq(a, need_dab)
    dk, dv = _launch_dkv(a)
    return dq, dk, dv, dab


def _plain(t: torch.Tensor) -> bool:
    """The plain versions serve CPU tensors; CUDA tensors launch the kernels."""
    return t.device.type == "cpu"


def _forward(q, k, v, ab, segment_ids, causal: bool, sm_scale: float, block_k, residuals: bool):
    if _plain(q):
        return flash_attention_reference(q, k, v, ab, segment_ids, causal, sm_scale, block_k)
    return _launch(q, k, v, ab, segment_ids, causal, sm_scale, residuals)


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention with JAX's VJP: the forward saves q, k, v, ab, the
    segment ids, o and the residuals l and m; the backward returns dq, dk,
    dv and d`ab` (the plain versions on CPU tensors, the dQ and dK/dV kernels
    on CUDA ones)."""

    @staticmethod
    def forward(ctx, q, k, v, ab, seg_q, seg_kv, causal, sm_scale, block_k):
        segs = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        o, l, m = _forward(q, k, v, ab, segs, causal, sm_scale, block_k, residuals=True)
        ctx.save_for_backward(q, k, v, ab, seg_q, seg_kv, o, l, m)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        # The plain version's causal skip follows its forward blocking
        ctx.causal_block_k = CAUSAL_BLOCK if block_k is None else block_k
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, ab, seg_q, seg_kv, o, l, m = ctx.saved_tensors
        segs = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        need_dab = ab is not None and ctx.needs_input_grad[3]
        if _plain(q):
            dq, dk, dv, dab = flash_attention_bwd_reference(
                q, k, v, ab, segs, o, l, m, do, ctx.causal, ctx.sm_scale,
                block_k=ctx.causal_block_k)
        else:
            dq, dk, dv, dab = _launch_bwd(q, k, v, ab, segs, o, l, m, do, ctx.causal,
                                          ctx.sm_scale, need_dab)
        return dq, dk, dv, dab if need_dab else None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ab: Optional[torch.Tensor] = None,
                    segment_ids: Optional[SegmentIds] = None, *, causal: bool = False,
                    sm_scale: float = 1.0, block_k: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Sq, hd), k and v (B, H, Skv, hd) bfloat16 views with hd
    contiguous; ab None or a float32 / bfloat16 (B, H, Sq, Skv) bias;
    segment_ids a SegmentIds (or (q, kv) pair) of integer (B, Sq) and
    (B, Skv) tensors. Returns (B, H, Sq, hd) bfloat16, differentiable in q,
    k, v and ab. CPU tensors take the plain versions in block_k's blocking
    (default: the kernel's); CUDA tensors launch the kernels."""
    if segment_ids is not None:
        segment_ids = SegmentIds(*segment_ids)
    _check(q, k, v, ab, segment_ids)
    sm_scale = float(sm_scale)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, ab)):
        seg_q, seg_kv = segment_ids if segment_ids is not None else (None, None)
        return FlashAttentionFn.apply(q, k, v, ab, seg_q, seg_kv, bool(causal), sm_scale,
                                      block_k)
    return _forward(q, k, v, ab, segment_ids, bool(causal), sm_scale, block_k, residuals=False)[0]
