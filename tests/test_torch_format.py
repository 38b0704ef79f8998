"""The port's results actions and logging against novic_tpu's (CPU, host code,
the 'test:32' hash embedder where a tower is needed).

* render_table prints what tabulate's "pretty" table (left-aligned) prints,
  on ragged, empty, padded and non-ASCII tables; sort_table_rows orders as
  novic_tpu's does.
* format_preds in all four modes over seeded predictions and annotation
  JSONs: the returned grids equal, and the printed tables (capsys) equal the
  JAX action's tabulate-printed ones.
* format_metrics and format_wandb over seeded run dirs (the local arm), and
  format_wandb's API arm under a fake wandb module (tests/test_cli.py:388):
  the filter dicts equal build_wandb_filters', and the rows equal.
  parse_duration_str / parse_datetime_str equal novic_tpu's.
* sample_images, random and special-weighted: the same chosen files.
* collect_wiki_images under a fake urllib.request.urlopen that serves the
  search, image-list and imageinfo JSON and one small and one large PNG:
  the same files, resized the same way, in both output directories, and the
  retry path taken once. Nothing is fetched.
* MetricsLogger under a fake wandb: the init/log/Table/finish calls are
  novic_tpu's; without wandb it warns and writes metrics.jsonl.
"""

import datetime
import io
import json
import logging
import os
import sys
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import PIL.Image
import pytest
import tabulate
import torch

from novic_tpu.cli import actions_eval as jax_eval
from novic_tpu.cli.train import main as jax_main
from novic_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from novic_tpu_torch.cli import actions_eval
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.utils.logger import log as port_log
from novic_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(2)
CPU = ["--device=cpu"]
NOUNS = ["dog", "cat", "fire truck", "apple", "sea lion"]
VOCAB = [{"id": i, "target_noun": n, "pretty_noun": n.title(), "singulars": [n],
          "plurals": [n + "s"], "singulars_freq": [1], "plurals_freq": [1], "hypernyms": []}
         for i, n in enumerate(NOUNS)]
CATEGORIES = ["correct_primary", "correct_secondary", "close_primary", "close_secondary",
              "incorrect"]


def common_args(d, out="outputs"):
    return ["embedder=test:32", f"vocab_path={d}/vocab.json", "prompt_path=",
            "prompt_collection=Basic", "hypernym_collection=None", "seed=5",
            f"output_dir={d}/{out}"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("format")
    with open(d / "vocab.json", "w") as f:
        json.dump(VOCAB, f)
    return d


def tables(text: str) -> list[str]:
    """The printed table lines (log lines go elsewhere or are dropped)."""
    return [line for line in text.splitlines() if line[:1] in ("+", "|")]


TABLES = [
    (("Sample", "Prediction 1", "Prediction 2"),
     [("a", "dog = 0.5 ✓"), ("longer sample", "c", "x")]),
    (("Sample", "P1", "P2", "P3"), [("a", "b"), ("c", "d", "e")]),   # headers cut to the rows
    (("S", "Pred"), [("a", 1.5, None), ("bb", 10, "zz")]),          # a front header padded
    (("S", "Pred"), []),
    (("Model", "Top-1 Details"), [("  padded  ", " 1/0✓ 0/0~ 1/0✗ = 2"), ("x", "")]),
    (("Gen Cfg", "Mean Top-k", "m1"), [("greedy", "50.0% -", "-"), ("beam", "1.0% 2.0%", "12.5%")]),
    (("宽", "b"), [("中文", "é"), ("x", "ß")]),
]


@pytest.mark.parametrize("headers,rows", TABLES)
def test_render_table_equals_tabulate(headers, rows):
    want = tabulate.tabulate(rows, headers=headers, tablefmt="pretty", numalign="left",
                             stralign="left")
    assert actions_eval.render_table(headers, rows) == want


@pytest.mark.parametrize("spec", ["", "model", "-model", "+0top-1", "-0Top-1", "0gen cfg",
                                  "missing", "-0missing"])
def test_sort_table_rows_matches_jax(spec):
    headers = ("Model", "Top-1", "Gen Cfg")
    rows = [("b", "12.5", "g1"), ("a", "n/a", "g2"), ("c", "3.25e1", "g0"), ("d", "-1", "g3"),
            ("e", 7.0, "g4")]
    if "top-1" not in spec.lower():
        rows = [r for r in rows if not isinstance(r[1], float)]
    want = jax_eval.sort_table_rows(list(rows), headers, spec)
    assert actions_eval.sort_table_rows(list(rows), headers, spec) == want


def _predictions(rng, models: list[str], keys: list[str], gencfgs: dict[str, int]) -> dict:
    out = {"version": 1, "models": {}, "keys": keys}
    for m in models:
        out["models"][m] = {"checkpoint": m, "embedder": "test:32", "vocab_targets": 5,
                            "guide_targets": 5, "gencfgs": {}}
        for g, k in gencfgs.items():
            preds = [list(rng.choice(NOUNS, size=k, replace=False)) for _ in keys]
            scores = [sorted(rng.uniform(-5, 0, size=k).tolist(), reverse=True) for _ in keys]
            out["models"][m]["gencfgs"][g] = {"pred": preds, "score": scores,
                                              "result": [["valid_guide"] * k for _ in keys]}
    return out


@pytest.fixture(scope="module")
def predictions(workdir):
    rng = np.random.default_rng(7)
    keys = ["a photo of a dog", "a photo of a cat", "/imgs/x/apple_1.png", "/imgs/sea.png",
            "unannotated text"]
    paths = []
    for i, models in enumerate((["ovod_a.npz"], ["ovod_b.npz", "ovod_c.npz"])):
        p = f"{workdir}/preds_{i}.json"
        with open(p, "w") as f:
            json.dump(_predictions(rng, models, keys, {"beam_k3_vnone_gp_t1_a0": 3,
                                                       "greedy_k1_vnone_gn_t1_a0": 1}), f)
        paths.append(p)
    ann = {}
    for k in keys[:-1]:
        key = os.path.basename(k)
        ann[key] = {c: [] for c in CATEGORIES}
        for noun in NOUNS:
            ann[key][CATEGORIES[int(rng.integers(0, len(CATEGORIES)))]].append(noun)
        ann[key]["close_secondary"].append("dog")  # a multi-category noun
    ann_path = f"{workdir}/annotations.json"
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    spec_path = f"{workdir}/specificity.json"
    with open(spec_path, "w") as f:
        json.dump({"dog": 0.5, "apple": 0.9}, f)
    return paths, ann_path, spec_path


@pytest.mark.parametrize("mode,extra", [
    ("nouns_v1", ["format_topk=2", "format_sort=-sample"]),
    ("nouns_v1", []),
    ("model_topk_v1", ["format_sort=-0top-1"]),
    ("model_topk_v1", ["format_model_spec=false", "format_topk=1"]),
    ("model_max_v1", []),
    ("gencfg_model_v1", ["format_sort=gen cfg"]),
])
def test_format_preds_matches_jax(workdir, predictions, capsys, mode, extra):
    paths, ann_path, spec_path = predictions
    args = [f"predictions_paths=[{paths[0]}, {paths[1]}]", f"annotations_paths=[{ann_path}]",
            f"format_mode={mode}", "action=format_preds"] + extra + common_args(workdir)
    if mode == "nouns_v1" and not extra:
        args.append(f"specificity_path={spec_path}")
    capsys.readouterr()
    want = jax_main(args)
    want_out = tables(capsys.readouterr().out)
    got = main(args + CPU)
    got_out = tables(capsys.readouterr().out)
    assert got == want
    assert got_out == want_out and len(got_out) > 4


def _write_run(root, name, cfg, records):
    run = root / name
    run.mkdir(parents=True)
    with open(run / "config.json", "w") as f:
        json.dump(cfg, f)
    with open(run / "metrics.jsonl", "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")


@pytest.fixture(scope="module")
def run_dirs(workdir):
    root = workdir / "runs"
    _write_run(root, "ovod_20260101_000000", {"action": "eval", "load_model": "m1.npz"},
               [{"_step": 1, "model": "m1", "dataset": "cache.bin", "loss": 1.25,
                 "token_top1": 0.5, "noun_top1": 0.25}])
    _write_run(root, "ovod_20260102_000000", {"action": "infer"},
               [{"_step": 1, "model": "m2", "gencfg": "beam_k3_vnone_gp_t1_a0", "samples": 3,
                 "predictions_path": "/x.json"},
                {"_step": 1, "_table": "t", "columns": [], "rows": [], "model": "m2"}])
    _write_run(root, "ovod_20260103_000000", {"action": "train"},
               [{"_step": 1, "chunk": 1, "loss": 3.5, "top1": 0.1},
                {"_step": 2, "chunk": 2, "loss": 2.5, "top1": 0.2, "top1_max": 0.2}])
    _write_run(root, "ovod_20260104_000000", {"action": "eval_cls_decoding"},
               [{"_step": 1, "model": "m1", "dataset": "MNIST", "gencfg": "g", "top1": 12.5}])
    return root


@pytest.mark.parametrize("action,extra", [
    ("format_metrics", []),
    ("format_wandb", ["fmt_type=all_v1"]),
    ("format_wandb", ["fmt_type=infer_v1"]),
    ("format_wandb", ["fmt_type=eval_gen_cls_v1", "fmt_models=m1", "fmt_sort=-0loss"]),
    ("format_wandb", ["fmt_type=all_v2", "use_wandb=true"]),   # no wandb: the local arm
])
def test_results_database_matches_jax(workdir, run_dirs, capsys, monkeypatch, action, extra):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    args = [f"action={action}", f"output_dir={run_dirs}"] + extra + common_args(workdir)[:-1]
    capsys.readouterr()
    want = jax_main(args)
    want_out = tables(capsys.readouterr().out)
    got = main(args + CPU)
    got_out = tables(capsys.readouterr().out)
    assert got == want and want
    assert got_out == want_out


class _Run:
    def __init__(self, name, action, history, log_text=""):
        self.name = name
        self.config = {"action": action, "load_model": "ovod_x/ck.npz"}
        self._history = history
        self._log = log_text

    def scan_history(self):
        return iter(self._history)

    def file(self, name):
        run = self

        class F:
            def download(self, replace=True, exist_ok=True):
                return io.StringIO(run._log)
        return F()


def fake_wandb_api(captured: list):
    class Api:
        def runs(self, path, filters):
            captured.append((path, filters))
            return [_Run("run-eval", "eval", [{"model": "m1", "dataset": "d", "loss": 1.5,
                                               "_step": 0}, {"model": "m9", "loss": 2.0}]),
                    _Run("run-infer", "infer", [],
                         log_text="[beam_k2_vnone_gn_t1_a0] img.jpg --> dog\n"
                                  "[greedy_k1_vnone_gn_t1_a0] a b c --> sea lion\n")]
    module = types.ModuleType("wandb")
    module.Api = Api
    return module


def test_format_wandb_api_arm_matches_jax(workdir, monkeypatch, capsys):
    captured = []
    monkeypatch.setitem(sys.modules, "wandb", fake_wandb_api(captured))
    args = ["action=format_wandb", "fmt_type=all_v1", "use_wandb=true", "wandb_entity=team",
            "fmt_min_stamp=20240101", "fmt_max_stamp=20260102",
            "fmt_hosts=tpu-.* hostA", "fmt_models=m1"] + common_args(workdir)
    capsys.readouterr()
    want = jax_main(args)
    want_out = tables(capsys.readouterr().out)
    got = main(args + CPU)
    got_out = tables(capsys.readouterr().out)
    assert got == want and got_out == want_out
    assert captured[0] == captured[1] and captured[0][0] == "team/novic_tpu"
    assert any(r[0] == "run-infer" and r[4] == {"pred": "sea lion"} for r in got)

    # The filters at a fixed time, relative windows included
    now = datetime.datetime(2026, 8, 16, 12, tzinfo=datetime.timezone.utc)
    from novic_tpu.utils.config import load_config as jax_load_config
    from novic_tpu_torch.utils.config import load_config

    overrides = ["action=format_wandb", "fmt_max_ago=1w2d3h", "fmt_min_ago=30m",
                 "fmt_min_stamp=20240101", "fmt_models=m1 dir/m2", "fmt_hosts=h1 gpu-[0-9]+"]
    for wanted in ({"eval"}, {"eval", "infer", "eval_cls"}):
        assert actions_eval.build_wandb_filters(load_config(None, overrides), wanted, now) == \
            jax_eval.build_wandb_filters(jax_load_config(None, overrides), wanted, now)


@pytest.mark.parametrize("duration", ["", "1d", "1w2d3h", "2y", "4h5m6s", "10S", "3W"])
def test_parse_duration_matches_jax(duration):
    now = datetime.datetime(2026, 8, 16, tzinfo=datetime.timezone.utc)
    assert actions_eval.parse_duration_str(duration, now) == \
        jax_eval.parse_duration_str(duration, now)


def test_parse_bad_duration_and_stamps_match_jax():
    now = datetime.datetime(2026, 8, 16, tzinfo=datetime.timezone.utc)
    for bad in ("nonsense", "1d2y"):
        with pytest.raises(ValueError):
            actions_eval.parse_duration_str(bad, now)
        with pytest.raises(ValueError):
            jax_eval.parse_duration_str(bad, now)
    for stamp in ("", "20260101", 20260101, "20260101_120000"):
        assert actions_eval.parse_datetime_str(stamp) == jax_eval.parse_datetime_str(stamp)
    text = "x\n[g1] k --> v\n[bad key] k --> v\n[g2] a b --> c d  \n"
    assert actions_eval.scrape_infer_log(text) == jax_eval.scrape_infer_log(text)


@pytest.fixture(scope="module")
def image_dir(workdir):
    src = workdir / "imgs"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(12):
        PIL.Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            src / f"img{i:02d}.png")
    (src / "notes.txt").write_text("not an image")
    return src


@pytest.mark.parametrize("extra", [["sample_count=5"],
                                   ["sample_count=4", "sample_special=[dog, cat]",
                                    "sample_special_factor=[20.0, 10.0]",
                                    "sample_special_mean=-0.2", "batch_size_image=5"]])
def test_sample_images_matches_jax(workdir, image_dir, extra):
    args = ["action=sample_images", f"sample_input_dir={image_dir}",
            f"sample_output_dir={workdir}/sampled"] + extra + common_args(workdir)
    out_j, chosen_j = jax_main(args)
    out_p, chosen_p = main(args + CPU)
    assert chosen_p == chosen_j and len(set(chosen_p)) == len(chosen_p)
    assert out_p != out_j and sorted(os.listdir(out_p)) == sorted(chosen_p)


def _png(w, h, seed) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    PIL.Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


class FakeWiki:
    """urlopen for the Wikipedia API and two image hosts: per noun a search hit,
    three image titles (a PNG, a JPG and a PDF), image info for a small PNG
    (120x100), a large JPG-named PNG (1200x900, resized to <= 0.8 MP) and a
    50x50 icon (under the size filter); the first request fails once."""

    SIZES = {"Small.png": (120, 100), "Large.jpg": (1200, 900), "Icon.png": (50, 50)}

    def __init__(self):
        self.calls, self.failed, self.unexpected = 0, 0, []

    def __call__(self, req, timeout=None):
        self.calls += 1
        if self.calls == 1:
            self.failed += 1
            raise urllib.error.URLError("temporary failure")
        url = req.full_url
        parsed = urllib.parse.urlparse(url)
        if url.startswith("https://upload.test/"):
            name = os.path.basename(parsed.path)
            w, h = self.SIZES[name.split("_", 1)[1]]
            return io.BytesIO(_png(w, h, seed=len(name)))
        q = dict(urllib.parse.parse_qsl(parsed.query))
        if not url.startswith("https://en.wikipedia.org/w/api.php") or q.get("format") != "json":
            self.unexpected.append(url)
            raise AssertionError(url)
        if q.get("list") == "search":
            body = {"query": {"search": [{"title": q["srsearch"].title()}]}}
        elif q.get("prop") == "images":
            body = {"query": {"pages": {"7": {"images": [
                {"title": "File:Small.png"}, {"title": "File:Large.jpg"},
                {"title": "File:Icon.png"}, {"title": "File:Doc.pdf"}]}}}}
        else:
            name = q["titles"].split(":", 1)[1]
            w, h = self.SIZES[name]
            noun = "x"
            body = {"query": {"pages": {"9": {"imageinfo": [
                {"url": f"https://upload.test/{noun}{len(name)}_{name}", "width": w,
                 "height": h}]}}}}
        return io.BytesIO(json.dumps(body).encode())


def test_collect_wiki_images_matches_jax(workdir, monkeypatch):
    sleeps = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    out = {}
    for label, run, extra in (("jax", jax_main, []), ("port", main, CPU)):
        fake = FakeWiki()
        monkeypatch.setattr(urllib.request, "urlopen", fake)
        d = workdir / f"wiki_{label}"
        run(["action=collect_wiki_images", f"wiki_output_dir={d}", "wiki_image_limit=3"]
            + common_args(workdir) + extra)
        assert fake.failed == 1 and not fake.unexpected
        out[label] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert sleeps == [1.0, 1.0]  # one retry in each package
    assert out["port"] == out["jax"]
    assert len(out["port"]) == 2 * len(NOUNS)
    for name, data in out["port"].items():
        w, h = PIL.Image.open(io.BytesIO(data)).size
        assert (w, h) == ((120, 100) if name.endswith("Small.png") else (1032, 774))


def _recording_wandb(calls: list):
    module = types.ModuleType("wandb")
    module.init = lambda **kw: calls.append(("init", kw))
    module.log = lambda metrics: calls.append(("log", metrics))
    module.Table = lambda columns, data: ("Table", columns, data)
    module.finish = lambda: calls.append(("finish",))
    return module


def _drive(logger_cls, run_dir):
    m = logger_cls(run_dir=run_dir, use_wandb=True, project="p", config={"a": 1, "b": [2]},
                   name="n2", wandb_kwargs={"entity": "e", "group": "", "name": "n1",
                                            "tags": ["t"], "job_type": None})
    m.log({"loss": 1.5, "arr": [1, 2], "model": "m"})
    m.log_table("tbl", ["c1", "c2"], [["x", 1], ["y", 2]])
    m.finish()


def test_metrics_logger_wandb_passthrough(tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    for label, cls in (("jax", JMetricsLogger), ("port", MetricsLogger)):
        monkeypatch.setitem(sys.modules, "wandb", _recording_wandb(calls[label]))
        _drive(cls, str(tmp_path / label))
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", {"project": "p", "config": {"a": 1, "b": [2]},
                                         "entity": "e", "name": "n2", "tags": ["t"]})
    lines = {label: [{k: v for k, v in json.loads(x).items() if k != "_time"}
                     for x in open(tmp_path / label / "metrics.jsonl")] for label in calls}
    assert lines["port"] == lines["jax"]


def test_metrics_logger_without_wandb_warns(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    port_log.addHandler(handler)
    try:
        m = MetricsLogger(run_dir=str(tmp_path), use_wandb=True, config={"a": 1})
        m.log({"loss": 2.0})
        m.finish()
    finally:
        port_log.removeHandler(handler)
    assert any("wandb requested but not installed" in r for r in records)
    (line,) = open(tmp_path / "metrics.jsonl").read().splitlines()
    assert json.loads(line)["loss"] == 2.0
    assert json.load(open(tmp_path / "config.json")) == {"a": 1}
