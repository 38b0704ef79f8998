"""Time X6b, the backward of flash attention (csrc/flash_attention_bwd.cu),
against an earlier revision of the same source, alternated in one process on
one card.

    python -m novic_tpu_torch.tools.flash_backward_ab --parent <flash_attention_bwd.cu> [--pairs 5]

The earlier source is one with the strided C entries, whose dK/dV and dQ
kernels read di from a torch reduction, e.g. `git show <rev>:novic_tpu_torch/
ops/csrc/flash_attention_bwd.cu` put under build/; it is compiled beside the
checkout's csrc/*.cuh headers into build/novic_tpu_torch/ under the name
flash_attention_bwd_parent. At the two harness shapes, (256, 12, 256, 64) and
(32, 16, 768, 80), each read in place from padded (B, Sp, H, hd) projections
with the harnesses' segment ids (and the forward kernel's o, l and m), it
runs both backwards, checks that they give the same dq, dk and dv within
chip_smoke.py's phase-3g bars (each element within one bf16 ulp plus 2^-7 of
the largest magnitude, the relative Frobenius error within 2^-8), and times
in the order parent, current, current, parent, ... for `pairs` pairs (CUDA
events, `iters` calls a sample):
  * "dkv": one dK/dV launch on prepared inputs;
  * "dq": one dQ launch on prepared inputs (the current one computes di);
  * "whole": the whole backward with its host code. The parent's, as its
    wrapper ran it: the cotangent check, di = sum(o * do) in torch, the
    segment ids, the strides, then dK/dV and dQ; the current one's
    `_launch_bwd`: the maps, dQ with di, dK/dV.
Prints one JSON line per shape: the medians, their ratios (current over
parent) and every sample, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess

import torch

from novic_tpu_torch.ops import flash_attention as fa
from novic_tpu_torch.tools.flash_forward_ab import SHAPES, _ms, _parent_library

REL_FRO = 2.0 ** -8  # chip_smoke.py BWD_REL_FRO


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn in (lib.novic_flash_attention_bwd_dkv, lib.novic_flash_attention_bwd_dq):
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _parent_operand(t: torch.Tensor) -> torch.Tensor:
    """The parent's 16-byte copies: aligned base, (batch, head, seq) strides
    in multiples of 8 elements (a size-1 dimension unchecked), else a copy."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1):
        return t
    return t.contiguous() if not t.is_contiguous() else t.clone()


def _parent_inputs(q, k, v, segs, o, l, m, do, scale) -> tuple:
    """The parent's launch arguments as its wrapper prepared them (no bias,
    no causal): the cotangent checked, di = sum(o * do) in torch, the int32
    segment ids, the strides; with the tensors they point at."""
    B, H, sq, hd = q.shape
    do = _parent_operand(do)
    di = (o.float() * do.float()).sum(dim=-1)
    seg_q, seg_kv = (t.to(torch.int32).contiguous() for t in segs)
    strides = []
    for t in (q, k, v, do):
        strides += list(t.stride()[:3])
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), None, l.data_ptr(),
            m.data_ptr(), di.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr()]
    tail = [fa._longs(strides + [0, 0, 0]), B, H, sq, k.shape[2], hd, 0, 0, scale,
            torch.cuda.current_stream().cuda_stream]
    return head, tail, (q, k, v, do, di, seg_q, seg_kv)


def _parent_launch(lib, prepared, part: str):
    """One parent launch: (dk, dv) for "dkv", dq for "dq"."""
    head, tail, keep = prepared
    q, k = keep[:2]
    B, H, sq, hd = q.shape
    if part == "dkv":
        dk = torch.empty((B, H, k.shape[2], hd), dtype=torch.bfloat16, device=q.device)
        dv = torch.empty_like(dk)
        err = lib.novic_flash_attention_bwd_dkv(*head, dk.data_ptr(), dv.data_ptr(), *tail)
        out = dk, dv
    else:
        out = torch.empty((B, H, sq, hd), dtype=torch.bfloat16, device=q.device)
        err = lib.novic_flash_attention_bwd_dq(*head, out.data_ptr(), None, *tail)
    if err:
        raise RuntimeError(f"the parent's {part} launch failed: CUDA error {err}")
    return out


def _parent_backward(lib, q, k, v, segs, o, l, m, do, scale):
    """The parent's whole backward as its wrapper ran it: (dq, dk, dv)."""
    prepared = _parent_inputs(q, k, v, segs, o, l, m, do, scale)
    dk, dv = _parent_launch(lib, prepared, "dkv")
    return _parent_launch(lib, prepared, "dq"), dk, dv


def _held(got: torch.Tensor, ref: torch.Tensor) -> dict:
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    diff = (got - ref).abs()
    rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    return {"max_abs_err": diff.max().item(), "rel_fro_err": rel,
            "ok": bool(torch.isfinite(got).all() and (diff <= ulp + 2.0 ** -7 * ref.abs().max())
                       .all() and rel <= REL_FRO)}


def compare(parent: ctypes.CDLL, pairs: int, iters: int, smi: str) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for label, B, H, sp, hd, real in SHAPES:
        q, k, v, do = (torch.randn(B, sp, H, hd, device="cuda", generator=gen)
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
        seg = (torch.arange(sp, device="cuda") < real).int()[None].repeat(B, 1).contiguous()
        segs = fa.SegmentIds(seg, seg)
        scale = 1.0 / math.sqrt(hd)
        o, l, m = fa._launch(q, k, v, None, segs, False, scale, residuals=True)
        a = fa._bwd_inputs(q, k, v, None, segs, o, l, m, do, False, scale)
        cur = {"dq": fa._launch_dq(a, False)[0]}
        cur["dk"], cur["dv"] = fa._launch_dkv(a)
        par = dict(zip(("dq", "dk", "dv"), _parent_backward(parent, q, k, v, segs, o, l, m, do,
                                                            scale)))
        whole = fa._launch_bwd(q, k, v, None, segs, o, l, m, do, False, scale, False)
        held = {g: _held(cur[g], par[g]) for g in ("dq", "dk", "dv")}
        held["whole_equals_launches"] = all(torch.equal(x, cur[g])
                                            for x, g in zip(whole[:3], ("dq", "dk", "dv")))
        prepared = _parent_inputs(q, k, v, segs, o, l, m, do, scale)
        runs = {
            "dkv": (lambda: _parent_launch(parent, prepared, "dkv"), lambda: fa._launch_dkv(a)),
            "dq": (lambda: _parent_launch(parent, prepared, "dq"),
                   lambda: fa._launch_dq(a, False)),
            "whole": (lambda: _parent_backward(parent, q, k, v, segs, o, l, m, do, scale),
                      lambda: fa._launch_bwd(q, k, v, None, segs, o, l, m, do, False, scale,
                                             False)),
        }
        samples = {part: {"parent": [], "current": []} for part in runs}
        for part, (run_parent, run_current) in runs.items():
            for order in (("parent", "current"), ("current", "parent")) * pairs:
                for key in order:
                    fn = run_parent if key == "parent" else run_current
                    samples[part][key].append(_ms(fn, iters=iters))
        med = {part: {key: statistics.median(x) for key, x in s.items()}
               for part, s in samples.items()}
        lines.append({
            "ab": "flash_attention_backward", "case": label, "shape": [B, H, sp, sp, hd],
            "gradients_within_3g_bars": held,
            "ok": all(h["ok"] for g, h in held.items() if g != "whole_equals_launches")
            and held["whole_equals_launches"],
            "median_ms": med,
            "ratio_current_to_parent": {p: x["current"] / x["parent"] for p, x in med.items()},
            "parent_dkv_plus_dq_ms": med["dkv"]["parent"] + med["dq"]["parent"],
            "samples_ms": samples, "iters_per_sample": iters,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
        del q, k, v, do, o, l, m, a, cur, par, whole, prepared
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the earlier flash_attention_bwd.cu")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_backward_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    parent = _bind(_parent_library(args.parent, "flash_attention_bwd_parent"))
    lines = compare(parent, args.pairs, args.iters, smi)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0 if all(line["ok"] for line in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
