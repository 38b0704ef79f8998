"""The `clip` tower family and the DFN5B-H-14-378 cell on the CPU: the plain
reference against the program's VisionTransformer at a small size (and
that it fails without ln_pre, the class token or ln_post, or with the other
activation), the shipped config's counts pinned by hand, the registry
check, a tiny run of the cell with its decoder drawn at 1024 (correct; its
control and each serving fault not), and the cell's two new readers."""

import contextlib
import json
import types

import pytest
import torch

from conftest import ROOT, tiny_cell
from port_bench import bounds, faults, harness

WL = "dfn5b_h14_378_f1024.offline_b64_unguided"
CLIP = ROOT / "port_bench" / "reference" / "families" / "clip.py"
# DFN5B's tower cut to 2 layers of width 160, 2 heads of 80, a 42-px image
# with patch 14 (S = 3 x 3 + 1 = 10), float32 compute
SMALL = {"layers": 2, "width": 160, "heads": 2, "mlp_dim": 640, "image_size": 42,
         "compute_dtype": "float32"}


def small_tower() -> dict:
    tower = dict(harness.load_cell(ROOT, WL).config["tower"])
    tower.update(SMALL)
    return tower


def mutant(old: str, new: str):
    """clip.py with one line of its forward replaced, as a module of its own."""
    source = CLIP.read_text()
    assert source.count(old) == 1, old
    module = types.ModuleType("clip_mutant")
    exec(compile(source.replace(old, new), str(CLIP), "exec"), module.__dict__)
    return module


MUTANTS = {
    "no_ln_pre": ('x = _ln(x, p["pre_ln_weight"], p["pre_ln_bias"], eps)', "pass"),
    "no_class_token": ('x = torch.cat([p["class_embedding"].expand(x.shape[0], 1, -1), x], '
                       'dim=1) + p["pos_embedding"]', 'x = x + p["pos_embedding"][1:]'),
    "no_ln_post": ('pooled = _ln(x[:, 0], p["post_ln_weight"], p["post_ln_bias"], eps)',
                   "pooled = x[:, 0]"),
}


def float32_attention(q, k, v, bias=None, key_bias=None):
    """Softmax attention of (B, S, H, hd) float32 operands in float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q / q.shape[-1] ** 0.5, k)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


@pytest.fixture(scope="module")
def program_and_reference():
    """The program's tower from the registry's DFN5B arch, cut to SMALL, and
    the reference's weights, on one seeded draw; the program's output on a
    normalised input as it runs (its attention rounds q, k, v and the
    probabilities to bf16, as K1 does, on the CPU too) and with a float32
    attention in its place, so that the comparison sees the tower's
    structure at float32's precision."""
    import novic_tpu_torch.embedders.vit as vit

    tower = small_tower()
    clip = harness.family_module(tower, ROOT)
    arch = harness.tower_arch(tower, clip, reduced=sorted(SMALL))
    cell = harness.Cell(workload=WL, entry={}, config={"tower": tower}, mix={}, limits={},
                        end_to_end=[], per_layer=[])
    weights = harness.tower_weights(harness.Run(ROOT, cell, 3_300_000_017, 1.0, False,
                                                device="cpu"))
    program = vit.VisionTransformer(arch.vision)
    program.load_state_dict(weights, strict=True)
    x = torch.randn(3, 42, 42, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        as_run = program(x)
        mp.setattr(vit, "fused_attention", float32_attention)
        out = program(x)
    return tower, weights, x, out, as_run


def rel_gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# Both sides compute in float32 from the same weights and input; they differ
# only in the order of the sums (matmul blocking, the softmax, the norms'
# reductions), a few ulps of float32 through two blocks (3.8e-7 of the
# output's largest value at this seed): 1e-5 leaves room above that and lies
# far below what a missing part of the tower or the other activation moves
# (8e-3 and more: the mutants below fail by 100 x TOL)
TOL = 1e-5


def test_clip_reference_matches_the_program(program_and_reference):
    tower, weights, x, out, as_run = program_and_reference
    clip = harness.family_module(tower, ROOT)
    with torch.no_grad():
        ref = clip.forward(weights, tower, x)
    assert ref.shape == out.shape == (3, 1024)
    assert rel_gap(out, ref) < TOL
    # as the program runs, the attention's bf16 operands move the direction
    # of the embedding by about 2e-6 (1 - cos), 1e-4 leaving room
    assert 0 < harness.cosine_gap(as_run, ref) < 1e-4


@pytest.mark.parametrize("name", [*sorted(MUTANTS), "quick_gelu"])
def test_clip_reference_without_a_part_fails(program_and_reference, name):
    tower, weights, x, out, _ = program_and_reference
    if name == "quick_gelu":
        module, tower = harness.family_module(tower, ROOT), dict(tower, act="quick_gelu")
    else:
        module = mutant(*MUTANTS[name])
    with torch.no_grad():
        ref = module.forward(weights, tower, x)
    assert rel_gap(out, ref) > 100 * TOL


def test_shipped_config_counts_by_hand():
    tower = harness.load_cell(ROOT, WL).config["tower"]
    assert bounds.tower_tokens(tower) == 27 * 27 + 1 == 730
    E, M, S, L = 1280, 5120, 730, 32
    patch = 2 * 729 * 14 * 14 * 3 * E
    block = 2 * 4 * S * E * E + 2 * 2 * S * S * E + 2 * 2 * S * E * M
    assert bounds.tower_flops(tower) == patch + L * block + 2 * E * 1024 == 1_006_962_882_560
    gemm = harness.metric_reader(ROOT, "tower_gemm_roofline.offline").tower_gemm_flops
    # the bf16 GEMMs: everything but the attention's S x S products and the projection
    assert gemm(tower) == (1 + 6 * L, patch + L * (2 * 4 * S * E * E + 2 * 2 * S * E * M))
    assert gemm(tower)[1] == 919_649_925_120


def test_load_cell_and_registry_check():
    cell = harness.load_cell(ROOT, WL)
    assert (cell.config["name"], cell.mix["batch"], cell.mix["gencfg"]) == \
        ("dfn5b_h14_378_f1024", 64, "beam_k10_vnone_gn_t1_a0")
    assert cell.config["decoder"]["weights"] == "seed"
    assert cell.config["decoder"]["embed_dim"] == cell.config["tower"]["embed_dim"] == 1024
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s", "setup_s"}
    assert {"dense_launches.offline", "tower_gemm_roofline.offline", "ln_launches.offline",
            "k1_roofline.offline"} <= {m["name"] for m in cell.per_layer}
    assert not {"tower_ms.offline", "decode_ms.offline"} & {m["name"] for m in cell.per_layer}
    tower = cell.config["tower"]
    clip = harness.family_module(tower, ROOT)
    v = harness.tower_arch(tower, clip, cell.config["reduced"]).vision
    assert (v.width, v.layers, v.heads, v.mlp_dim, v.embed_dim, v.act, v.pool) == \
        (1280, 32, 16, 5120, 1024, "gelu", "cls")
    assert v.use_class_token and v.pre_ln and not v.patch_bias and not v.proj_bias
    for key, value in (("act", "quick_gelu"), ("pre_ln", False), ("mlp_dim", 4096)):
        with pytest.raises(harness.CellError):
            harness.tower_arch(dict(tower, **{key: value}), clip, [])


@pytest.mark.parametrize("side", ["program", "control", *sorted(faults.SERVING)])
def test_tiny_clip_cell_with_a_seeded_decoder(side):
    """One layer of DFN5B's tower at a 28-px image and the decoder drawn at
    1024: correct as the program runs it, not correct with the control in
    its place or with a fault in its timed path."""
    run = harness.Run(ROOT, tiny_cell(WL), 3_300_000_019, 0.5, False, device="cpu")
    run.control = side == "control"
    with faults.SERVING[side]() if side in faults.SERVING else contextlib.nullcontext():
        result = harness.execute(run)
    assert {"embed_gap", "score_gap"} <= set(result["checks"])
    assert result["correct"] is (side == "program"), result["checks"]


# -- the two readers on synthetic records --------------------------------------------

def synthetic_run(counters: dict, kernels: list, towers: int = 2):
    spans = [{"name": "tower", "phase": "traced", "t0": 10.0 + i, "t1": 10.5 + i, "images": 64}
             for i in range(towers)]
    recs = [{"name": "embed", "t0": 10.0 + i, "t1": 10.4 + i, "id": i, "parent": None, "seq": i,
             "thread": 1, "attrs": {"images": 64}} for i in range(towers)]
    run = types.SimpleNamespace(spans=spans, traced={"kernels": kernels},
                                config={"tower": harness.load_cell(ROOT, WL).config["tower"]})
    return run, recs, counters


@pytest.fixture
def recorder(monkeypatch):
    from novic_tpu_torch.utils import trace

    def install(recs, counters):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    return install


GEMM_S = 2 * 64 * 919_649_925_120 / 989e12   # two batches' GEMMs at the bf16 peak


@pytest.mark.parametrize("dense,kernels,expect", [
    (386, [["nvjet_tst_192x256_64x4", GEMM_S * 0.5], ["sm80_xmma_gemm_bf16bf16_bf16f32_f32",
                                                      GEMM_S * 0.5], ["attention_kernel", 1.0]],
     (193.0, 100.0)),
    (386, [["nvjet_tss_256x128", 2 * GEMM_S], ["sm80_xmma_gemm_f32f32_f32f32", 5.0]], (193.0, 50.0)),
    (384, [["nvjet_tss_256x128", GEMM_S]], (192.0, None)),        # not one call a product
    (386, [["cutlass_80_simt_sgemm_256x128", 1.0]], (193.0, None)),  # no bf16 GEMM kernel
    (None, [["nvjet_tss_256x128", GEMM_S]], (None, None)),        # a program without the counter
])
def test_dense_readers(recorder, dense, kernels, expect):
    run, recs, counters = synthetic_run({} if dense is None else {"tower.dense": dense}, kernels)
    recorder(recs, counters)
    got = [harness.metric_reader(ROOT, n).read(run, n)
           for n in ("dense_launches.offline", "tower_gemm_roofline.offline")]
    assert got[0] == expect[0]
    assert got[1] == (None if expect[1] is None else pytest.approx(expect[1]))


def test_dense_readers_with_nothing_traced(recorder):
    run, recs, counters = synthetic_run({"tower.dense": 386}, [["nvjet_tss", GEMM_S]], towers=0)
    recorder(recs, counters)
    run.traced = None
    for n in ("dense_launches.offline", "tower_gemm_roofline.offline"):
        assert harness.metric_reader(ROOT, n).read(run, n) is None


def test_manifest_entries():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    for name in ("dense_launches.offline", "tower_gemm_roofline.offline"):
        assert per_layer[name]["workloads"] == [WL] and per_layer[name]["moves"] == "images_per_s"
    assert [w for w in manifest["workloads"] if w["name"] == WL][0]["chips"] == 1


def test_tiny_traced_clip_run_counts_its_gemms():
    """A traced run of the tiny cell reads `tower.dense` once a product (the
    patch embedding and six in its one block); the CPU's profile holds no
    cuBLAS kernel, so the GEMMs' roofline has nothing to read."""
    from novic_tpu_torch.utils import trace

    trace.clear()
    run = harness.Run(ROOT, tiny_cell(WL), 3_300_000_023, 0.3, True, device="cpu")
    metrics = harness.execute(run)["metrics"]
    trace.clear()
    assert metrics["dense_launches.offline"]["value"] == 7.0
    assert "tower_gemm_roofline.offline" not in metrics
