"""Runs one cell of the benchmark once: set-up, the measured window, an
optional traced segment, the comparison with the plain reference, and the
result line.

Everything that belongs to one cell is found by name, so a new cell, model
configuration, traffic mix or per-layer metric is new files and entries:

* BENCHMARK.json (the checkout's root): the workload -> its config, traffic;
* port_bench/configs/<config>.json: the tower and decoder as they are run;
  a decoder with `"weights": "seed"` and its `embed_dim` is drawn from the
  run's seed in the committed checkpoint's layout (seeded_decoder);
* port_bench/reference/families/<family>.py: the tower family the config's
  `tower.family` names: `shapes`, `forward`, `tokens`, `flops`, `stated`
  and `CONTROL` (see reference/towers.py);
* port_bench/mixes/<traffic>.json: the mix's parameters and its `driver`;
* port_bench/drivers/<driver>.py: `setup`, `window`, `traced`, `release`
  and `check_inputs` for that kind of traffic (compare.py judges them);
* port_bench/limits/<workload>.json: the limit of each number compared;
* port_bench/metrics/<metric>.py, else <metric up to its first dot>.py: a
  `read(run, name)` that returns the metric's value or None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
import weakref
from pathlib import Path
from typing import Any, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "novic_tpu")


class CellError(RuntimeError):
    """The cell cannot run as defined (a missing file, a config the program
    does not run as stated, no card)."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    if not path.is_file():
        raise CellError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(f"port_bench_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(root: Path, name: str):
    """The reader module of a per-layer metric: metrics/<name>.py, else the
    file of the name up to its first dot (one reader for `tower_ms.offline`
    and `tower_ms.all`); None where there is neither."""
    for stem in (name, name.split(".", 1)[0]):
        path = root / "port_bench" / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path)
    return None


@dataclasses.dataclass
class Cell:
    workload: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict
    mix: dict
    limits: dict
    end_to_end: list     # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_cell(root: Path, workload: str) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == workload]
    if not entries:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    base = root / "port_bench"
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    config = load_json(base / "configs" / f"{entry['config']}.json")
    family_module(config["tower"], root)
    return Cell(workload=workload, entry=entry, config=config,
                mix=load_json(base / "mixes" / f"{entry['traffic']}.json"),
                limits=load_json(base / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def seed_words(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed (any size) and a salt."""
    h = hashlib.blake2b(f"{seed}:{salt}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & (2 ** 63 - 1)


class Run:
    """One run of a cell: its inputs, its spans and counters, its results."""

    def __init__(self, root: Path, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None):
        self.root, self.cell, self.seed, self.seconds, self.trace = root, cell, seed, seconds, trace
        self.config, self.mix, self.limits = cell.config, cell.mix, cell.limits
        self.device = device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.phase = "setup"
        self.spans: list[dict] = []
        self.counters: dict[str, Any] = {}
        self.window: dict = {}
        self.traced: Optional[dict] = None
        self.control = False          # judge the lower-precision control in the program's place
        self.program_checks: dict = {}
        self.decoder_file: Optional[Path] = None    # the seeded decoder, once written

    # -- inputs drawn from the seed ------------------------------------------------

    def generator(self, salt: int):
        import torch

        return torch.Generator(device=self.device).manual_seed(seed_words(self.seed, salt))

    def rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng(seed_words(self.seed, salt))

    def frames(self, n: int, size: int, salt: int = 1) -> np.ndarray:
        """(n, size, size, 3) uint8 frames drawn on the device, on the host."""
        import torch

        return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8, device=self.device,
                             generator=self.generator(salt)).cpu().numpy()

    # -- spans ---------------------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        """A host-clock span of the benchmark around a call into the program
        (in the traced segment, it labels the device's idle gaps)."""
        rec = {"name": name, "phase": self.phase, **meta}
        rec["t0"] = time.perf_counter()
        try:
            yield rec
        finally:
            rec["t1"] = time.perf_counter()
            self.spans.append(rec)

    def spans_of(self, name: str, phase: str = "window") -> list[dict]:
        return [s for s in self.spans if s["name"] == name and s["phase"] == phase]


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def free_device() -> None:
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def execute(run: Run) -> dict:
    """Set-up, window, traced segment, check: the result line's fields."""
    import torch

    driver = load_module(run.root / "port_bench" / "drivers" / f"{run.mix['driver']}.py")
    on_cuda = run.device.startswith("cuda")
    state = driver.setup(run)
    sync(run.device)
    run.phase = "window"
    run.t_window = time.perf_counter()
    setup_s = run.t_window - run.t_start
    run.window = driver.window(run, state)
    sync(run.device)
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    if run.trace:
        from port_bench import trace

        run.phase = "traced"
        before = launches()
        run.traced = trace.profile(lambda: driver.traced(run, state),
                                   lambda: [(s["t0"], s["t1"], s["name"])
                                            for s in run.spans if s["phase"] == "traced"])
        run.counters["trace_aligned"] = int(run.traced["aligned"])
        run.counters["launches_traced"] = {k: n - before[k] for k, n in launches().items()}
    run.phase = "check"
    sample = driver.release(run, state)
    del state
    free_device()
    from port_bench import compare

    inputs = driver.check_inputs(run, sample)
    if inputs.get("train"):
        checks = compare.compare_train(run, inputs)
    elif inputs["preds"]:
        checks = compare.compare(run, inputs)
    else:
        checks = {"rows": check_entry(1, 0)}
    if run.control and "rows" not in checks:
        # The control in the program's place: its readings, judged by the same limits
        run.program_checks = checks
        checks = {k: check_entry(v, run.limits[k]) for k, v in compare.control(run, inputs).items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics: dict[str, dict] = {}
    if not run.trace:
        values = dict(run.window["metrics"], setup_s=setup_s)
        for m in run.cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in run.cell.per_layer:
            reader = metric_reader(run.root, m["name"])
            value = reader.read(run, m["name"]) if reader is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(run.window["attempted"]),
              "failed": int(run.window["failed"]), "metrics": metrics,
              "device": device_info(run, memory_peak)}
    if run.traced is not None:
        result["device"].update(busy_s=run.traced["busy_s"], window_s=run.traced["window_s"])
        result["breakdown"] = {"device_ops": [[n[:200], s] for n, s in run.traced["device_ops"]],
                               "idle_gaps": run.traced["idle_gaps"]}
    result["checks"] = checks
    return result


def launches() -> dict:
    """The program's kernel launch counters (ops/*.LAUNCHES) by module."""
    from novic_tpu_torch import ops

    names = ("attention", "attention_bf16", "beam_reorder", "dropout", "flash_attention",
             "int8_matmul", "tiled_matmul")
    return {n: getattr(importlib.import_module(f"{ops.__name__}.{n}"), "LAUNCHES", 0)
            for n in names}


def device_info(run: Run, memory_peak: int) -> dict:
    import torch

    if run.device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(run.cell.entry.get("chips", 1)), "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def check_entry(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


# -- the program's serving model, built as the config states -------------------------

def family_module(tower: dict, root: Path):
    """The module of the tower's family: port_bench/reference/families/<family>.py
    in the checkout at `root` (a missing one is a CellError)."""
    return load_module(root / "port_bench" / "reference" / "families" / f"{tower['family']}.py")


def checkpoint_path(run: Run) -> Path:
    """The decoder checkpoint the config names, held to its recorded hash;
    for a decoder with `"weights": "seed"`, the file seeded_decoder wrote
    from it (written once a run, on the first call, in set-up)."""
    if run.decoder_file is not None:
        return run.decoder_file
    d = run.config["decoder"]
    path = run.root / d["checkpoint"]
    if not path.is_file():
        raise CellError(f"missing decoder checkpoint {path}")
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != d["sha256"]:
        raise CellError(f"{path} is not the checkpoint the config records ({digest})")
    if "weights" not in d:
        return path
    if d["weights"] != "seed":
        raise CellError(f"decoder weights {d['weights']!r}: only 'seed' is known")
    workdir = tempfile.mkdtemp(prefix="port_bench_decoder_")
    weakref.finalize(run, shutil.rmtree, workdir, True)
    run.decoder_file = Path(workdir) / "decoder.npz"
    seeded_decoder(run, path, run.decoder_file)
    return run.decoder_file


def seeded_decoder(run: Run, committed: Path, out: Path, salt: int = 41) -> None:
    """Write a decoder drawn from the run's seed to `out`, in the committed
    checkpoint's .npz layout: its parameter names and order, its stored
    dtype, its metadata (target nouns, target config, tokenizer) and every
    width but the embedding's, which the config's `embed_dim` states
    (`embed_mlp.linear1_weight` (P x hidden, embed_dim); the metadata's
    model_config says the same). The values are drawn on the device in one
    call, as draw_weights does: matrices N(0, 1/fan_in), norm scales 1 +
    N(0, 0.05^2), the token table (`logits_weight`, tied) and positions
    N(0, 0.02^2), as are biases, where a decoder has them."""
    d = run.config["decoder"]
    with np.load(committed, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        layout = {k: (data[k].shape, data[k].dtype) for k in data.files if k.startswith("params.")}
        order = [k for k in data.files if k in layout or k == "__meta__"]
    cfg = meta["model_config"]
    (rows, width), dtype = layout["params.embed_mlp.linear1_weight"]
    if cfg["mlp_hidden_layer"] != "none" or width != cfg["embed_dim"]:
        raise CellError(f"{committed}: the embedding does not enter through one linear layer")
    layout["params.embed_mlp.linear1_weight"] = (rows, d["embed_dim"]), dtype
    for key in ("hidden_dim", "num_layers", "num_heads", "mlp_seq_len", "token_length",
                "vocab_size"):
        if cfg[key] != d[key]:
            raise CellError(f"{committed}: {key} is {cfg[key]}, the config states {d[key]}")
    cfg["embed_dim"] = d["embed_dim"]
    drawn = draw_weights(run, {k[len("params."):]: s for k, (s, _) in layout.items()}, salt,
                         small=("pos_embedding", "logits_weight"))
    arrays = {f"params.{k}": v.cpu().numpy().astype(layout[f"params.{k}"][1])
              for k, v in drawn.items()}
    del drawn
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(out, **{k: arrays[k] for k in order})


def tower_arch(tower: dict, family, reduced: list, quant: str = ""):
    """The program's registered architecture for the tower's spec, with the
    config's values (the shared ones and the family module's `stated`); a
    value that differs from the registry where the config does not list it
    as reduced is refused."""
    from novic_tpu_torch.embedders.registry import lookup

    arch = lookup(tower["spec"])
    v = arch.vision
    stated = {"image_size": tower["image_size"], "patch_size": tower["patch_size"],
              "width": tower["width"], "layers": tower["layers"], "heads": tower["heads"],
              "embed_dim": tower["embed_dim"], "layer_norm_eps": tower["layer_norm_eps"],
              "compute_dtype": tower["compute_dtype"]}
    stated.update(family.stated(tower))
    for key, value in stated.items():
        if getattr(v, key) != value and key not in reduced:
            raise CellError(f"{tower['spec']}: the program runs {key}={getattr(v, key)}, "
                            f"the config states {value}")
    if quant:
        stated["quant"] = quant
    pre = dataclasses.replace(arch.preprocess, size=tower["image_size"])
    if tuple(pre.mean) != tuple(tower["mean"]) or tuple(pre.std) != tuple(tower["std"]):
        raise CellError(f"{tower['spec']}: the program normalises with other constants")
    return dataclasses.replace(arch, vision=dataclasses.replace(v, **stated), preprocess=pre)


def draw_weights(run: Run, shapes: dict, salt: int, small: tuple) -> dict:
    """float32 tensors of the given shapes, drawn on the device from the
    seed in one call and cut in the order given: leaves named in `small`
    and biases N(0, 0.02^2), other vectors (norm scales) 1 + N(0, 0.05^2),
    matrices N(0, 1/fan_in)."""
    import torch

    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), device=run.device, generator=run.generator(salt))
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        z = flat[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf in small or leaf.endswith("_bias"):
            z.mul_(0.02)
        elif len(shape) == 1:
            z.mul_(0.05).add_(1.0)
        else:
            z.mul_(shape[-1] ** -0.5)
        out[name] = z
    return out


def tower_weights(run: Run, salt: int = 7) -> dict:
    """The tower's float32 weights in its family's layout, drawn by
    draw_weights: positions, probe and class token N(0, 0.02^2) with the
    biases, norm scales 1 + N(0, 0.05^2), matrices N(0, 1/fan_in)."""
    tower = run.config["tower"]
    return draw_weights(run, family_module(tower, run.root).shapes(tower), salt,
                        small=("pos_embedding", "class_embedding", "map_probe"))


def port_model(run: Run, batch_size: int, gencfg: str, quant: str = ""):
    """The program's NOVICModel as the config states it, entered, with the
    benchmark's tower weights loaded and the FT0 decoder read from its file."""
    from novic_tpu_torch.embedders.base import TorchEmbedder
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.text.simple import make_test_tokenizer

    from port_bench.reference.decoder import read_checkpoint

    tower = run.config["tower"]
    ckpt = checkpoint_path(run)
    _, meta = read_checkpoint(str(ckpt))
    nouns = meta["target_nouns"][meta["num_invalid_target_nouns"]:]
    arch = tower_arch(tower, family_module(tower, run.root), run.config.get("reduced", []), quant)
    model = NOVICModel(str(ckpt), embedder_spec=tower["spec"], gencfg=gencfg,
                       batch_size=batch_size, device=run.device,
                       embedder_kwargs={"tokenizer": make_test_tokenizer(nouns)})
    model.embedder = TorchEmbedder(spec=tower["spec"], arch=arch, load_model=False, check=False,
                                   weights_path=None, tokenizer=make_test_tokenizer(nouns),
                                   compute_dtype=tower["compute_dtype"], seed=0,
                                   device=run.device, init_on_device=True,
                                   inference_batch_size=batch_size, image_batch_size=batch_size)
    with run.span("enter"):
        model.__enter__()
    # The towers are drawn on the device by the program; the vision tower
    # then takes the benchmark's weights (the reference gets the same draw)
    model.embedder._vision.load_state_dict(tower_weights(run), strict=True)
    return model


def reference_embeddings(run: Run, frames: np.ndarray, fp8: bool = False):
    """The plain reference's unit embeddings of uint8 frames, on the device."""
    import torch

    from port_bench.reference.towers import embed

    tower = run.config["tower"]
    weights = tower_weights(run)
    out = embed(family_module(tower, run.root).forward, weights, tower,
                torch.from_numpy(np.ascontiguousarray(frames)).to(run.device), fp8=fp8)
    del weights
    return out


def cosine_gap(a, b) -> float:
    """max over rows of 1 - cos(a_i, b_i), in float64."""
    import torch

    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    cos = (a * b).sum(-1) / a.norm(dim=-1) / b.norm(dim=-1)
    return float((1.0 - cos).max())
