"""CPU tests of the benchmark harness. `card` marks a test that needs a
CUDA card; it skips here, deciding inside the test."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the chip only)")


# SigLIP-L/16-256's tower as the registry states it: an embedding 1024 wide
SIGLIP_L = {"spec": "openclip:timm/ViT-L-16-SigLIP-256", "width": 1024, "heads": 16,
            "mlp_dim": 4096, "embed_dim": 1024}


def tiny_cell(workload: str, root: Path = ROOT, **mix_overrides):
    """The workload's cell with its tower cut to one layer and a small image
    and its mix to a few images: what a CPU run can hold."""
    from port_bench import harness

    cell = harness.load_cell(root, workload)
    config = json.loads(json.dumps(cell.config))
    t = config["tower"]
    t.update(layers=1, image_size=2 * t["patch_size"])
    config["reduced"] = ["layers", "image_size"]
    mix = dict(cell.mix)
    if mix["driver"] == "train":
        mix.update(rows=512, batch=32, accum=2, check_steps=3, warm_steps=1, traced_steps=1)
    else:
        mix.update(batch=4, pool_batches=2, check_batches=1, traced_batches=1, check_images=1)
    mix.update(mix_overrides)
    return harness.Cell(workload=workload, entry=cell.entry, config=config, mix=mix,
                        limits=cell.limits, end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def seeded_decoder_cell(workload: str, **mix_overrides):
    """The workload's tiny cell on SigLIP-L/16-256's tower, with a decoder
    drawn from the seed at its embedding width, 1024."""
    cell = tiny_cell(workload, **mix_overrides)
    cell.config["tower"].update(SIGLIP_L)
    cell.config["decoder"].update(weights="seed", embed_dim=SIGLIP_L["embed_dim"])
    return cell


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
