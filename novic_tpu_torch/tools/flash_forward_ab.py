"""Time X6's forward kernel (csrc/flash_attention.cu) against an earlier
revision of the same source, alternated in one process on one card.

    python -m novic_tpu_torch.tools.flash_forward_ab --parent <flash_attention.cu> [--pairs 5]

The earlier source is one with the segment-ids-only C entry (no bias, causal
or residual arguments), e.g. `git show <rev>:novic_tpu_torch/ops/csrc/
flash_attention.cu`; it is compiled beside the checkout's csrc/*.cuh headers
into build/novic_tpu_torch/ under the name flash_attention_parent. At the two
harness shapes, (256, 12, 256, 64) and (32, 16, 768, 80), each read in place
from padded (B, Sp, H, hd) projections with the harnesses' segment ids, it
runs the current kernel as flash_attention does without grad (no residuals),
checks that both write the same output, and times each (CUDA events, 50
launches a sample) in the order parent, current, current, parent, ... for
`pairs` pairs. Prints one JSON line per shape: the medians, their ratio and
every sample, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import statistics
import subprocess

import torch
import torch.nn.functional as F

from novic_tpu_torch.ops import build as _build
from novic_tpu_torch.ops import flash_attention as fa
from novic_tpu_torch.ops.attention_bf16 import _tma_plan, q_rows

# (label, B, H, Sp, hd, real tokens): the attn_variants and DFN5B harnesses
SHAPES = [("attn_variants", 256, 12, 256, 64, 196), ("dfn5b", 32, 16, 768, 80, 730)]


def _parent_library(source: str, stem: str = "flash_attention_parent") -> ctypes.CDLL:
    """An earlier revision's source compiled beside the checkout's csrc/*.cuh
    headers into build/novic_tpu_torch/ as libnovic_<stem>.so, loaded."""
    dst = _build.BUILD_DIR / "variants" / f"{stem}.cu"
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(source, dst)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copyfile(header, dst.parent / header.name)
    return ctypes.CDLL(str(_build.build(dst, force=True)))


def _ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(parent: ctypes.CDLL, pairs: int, smi: str) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for label, B, H, sp, hd, real in SHAPES:
        q, k, v = (torch.randn(B, sp, H, hd, device="cuda", generator=gen)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        seg = (torch.arange(sp, device="cuda") < real).int()[None].repeat(B, 1).contiguous()
        segs = fa.SegmentIds(seg, seg)
        scale = 1.0 / math.sqrt(hd)
        plan = []
        for t, rows in ((q, q_rows(hd)), (k, fa.KERNEL_BLOCK_K), (v, fa.KERNEL_BLOCK_K)):
            plan += _tma_plan(t.transpose(1, 2), sp, rows)
        seg_kv = F.pad(seg, (0, -sp % fa.KERNEL_BLOCK_K)).contiguous()
        out = torch.empty((B, H, sp, hd), dtype=torch.bfloat16, device="cuda")
        plan_p, strides_p = fa._longs(plan), fa._longs(out.stride()[:3])
        stream = torch.cuda.current_stream().cuda_stream

        def run_parent():
            err = parent.novic_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               out.data_ptr(), seg.data_ptr(), seg_kv.data_ptr(),
                                               plan_p, strides_p, B, H, sp, sp, hd, scale, stream)
            if err:
                raise RuntimeError(f"the parent kernel's launch failed: CUDA error {err}")

        def run_current():
            return fa._launch(q, k, v, None, segs, False, scale)[0]

        run_parent()
        same = bool(torch.equal(out, run_current()))
        samples = {"parent": [], "current": []}
        for order in (("parent", "current"), ("current", "parent")) * pairs:
            for key in order:
                samples[key].append(_ms(run_parent if key == "parent" else run_current))
        med = {key: statistics.median(v) for key, v in samples.items()}
        lines.append({"ab": "flash_attention_forward", "case": label, "shape": [B, H, sp, sp, hd],
                      "outputs_identical": same, "median_ms": med,
                      "ratio_current_to_parent": med["current"] / med["parent"],
                      "samples_ms": samples, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the earlier flash_attention.cu")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_forward_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    parent = _parent_library(args.parent)
    parent.novic_flash_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    parent.novic_flash_attention.restype = ctypes.c_int
    for line in compare(parent, args.pairs, smi):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
