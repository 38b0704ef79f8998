"""The port's orbax checkpoints (train/zstd.py, train/ocdbt.py,
train/orbax_format.py, train/checkpoint.py) against zstandard, tensorstore,
orbax and novic_tpu on the CPU.

* zstd: the port's decoder gives zstandard's bytes for every frame form
  zstandard writes (levels 1, 3, 9, 19 and a negative one, with and without a
  checksum and a content size, concatenated and skippable frames, streamed
  frames); truncated and bit-flipped frames raise ValueError. Its raw-block
  frames round-trip through zstandard.
* OCDBT: stores tensorstore writes (interior nodes, several commits, values
  inline or not, compressed or not) read through the port's reader; the port's
  stores read through tensorstore.
* Checkpoints: novic_tpu's save_checkpoint_orbax → the port's load_checkpoint,
  and the port's save_checkpoint_orbax → novic_tpu's load_checkpoint, bit for
  bit; a small decoder from a JAX orbax checkpoint gives the JAX decoder's
  logits; both CLIs resume from each other's .orbax checkpoints as from the
  same checkpoint in .npz form; NOVICModel takes an .orbax directory.
* The committed fixture tests/data/orbax_small.orbax/ and its twin
  orbax_small.npz, written by novic_tpu's savers (`python
  tests/test_torch_orbax.py` rewrites them): the port reads the directory bit
  for bit as the twin, and rebuilding gives the same arrays.
"""

import glob
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from novic_tpu.cli.train import main as jax_main
from novic_tpu.models.config import DecoderModelConfig as JConfig
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.text.simple import make_test_tokenizer as j_make_test_tokenizer
from novic_tpu.text.target import create_target_config as j_create_target_config
from novic_tpu.train import checkpoint as jckpt
from novic_tpu_torch.bridge import decoder_from_numpy
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.infer import NOVICModel
from novic_tpu_torch.train import checkpoint, ocdbt, orbax_format, zstd
from novic_tpu_torch.utils.misc import flatten_dict

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "orbax_small.orbax")
FIXTURE_NPZ = os.path.join(DATA, "orbax_small.npz")
FIXTURE_NOUNS = ["dog", "cat", "fire truck", "sea lion"]
RTOL = 1e-5  # tests/test_torch_decoder.py's


def _dtype_name(a: np.ndarray) -> str:
    """bfloat16 for ml_dtypes' and for the V2 an .npz gives it back as."""
    return "bfloat16" if a.dtype.name == "bfloat16" or a.dtype.str.endswith("V2") else a.dtype.str


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and _dtype_name(a) == _dtype_name(b)
            and a.tobytes() == b.tobytes())


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _assert_trees_equal(a, b):
    fa, fb = dict(_leaves(a)), dict(_leaves(b))
    assert set(fa) == set(fb)
    for k in fa:
        assert _same(fa[k], fb[k]), k


def _assert_checkpoints_equal(a: dict, b: dict):
    _assert_trees_equal(a["params"], b["params"])
    assert (a["opt_arrays"] is None) == (b["opt_arrays"] is None)
    if a["opt_arrays"] is not None:
        _assert_trees_equal(a["opt_arrays"], b["opt_arrays"])
    ma = {k: v for k, v in a["meta"].items() if k != "saved_unix_time"}
    mb = {k: v for k, v in b["meta"].items() if k != "saved_unix_time"}
    assert ma == mb


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "one": b"x",
        "zeros": bytes(300_000),
        "text": b"the quick brown fox jumps over the lazy dog; " * 9000,
        "float32": (rng.standard_normal(200_000) * 0.02).astype(np.float32).tobytes(),
        "float16": (rng.standard_normal(150_000) * 0.02).astype(np.float16).tobytes(),
        "bf16_in_f32": (rng.standard_normal(90_000) * 0.02).astype(ml_dtypes.bfloat16)
        .astype(np.float32).tobytes(),
        "int_pattern": np.tile(np.arange(300, dtype=np.int32), 500).tobytes(),
        "small_alphabet": rng.integers(0, 5, 70_000, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("level", [1, 3, 9, 19, -5])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("content_size", [True, False])
def test_zstd_decodes_what_zstandard_writes(level, checksum, content_size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    for name, data in _inputs().items():
        frame = c.compress(data)
        assert zstd.decompress(frame) == data, name
        assert zstd.content_size(frame) == (len(data) if content_size else None), name


def test_zstd_concatenated_skippable_and_streamed_frames():
    inputs = _inputs()
    c = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skippable = (0x184D2A53).to_bytes(4, "little") + (6).to_bytes(4, "little") + b"skipme"
    frames = c.compress(inputs["text"]) + skippable + c.compress(inputs["float32"])
    assert zstd.decompress(frames) == inputs["text"] + inputs["float32"]
    assert zstd.content_size(frames) == len(inputs["text"]) + len(inputs["float32"])
    # A streamed frame: no content size, several blocks written as they came
    co = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = b"".join(co.compress(inputs["float16"][i:i + 50_000])
                        for i in range(0, len(inputs["float16"]), 50_000)) + co.flush()
    assert zstd.content_size(streamed) is None
    assert zstd.decompress(streamed) == inputs["float16"]
    out = np.empty(len(inputs["float16"]) // 2, np.float16)
    zstd.decompress_into(streamed, out)
    assert out.tobytes() == inputs["float16"]
    with pytest.raises(ValueError, match="expected"):
        zstd.decompress_into(streamed, np.empty(10, np.float16))


def test_zstd_output_bound():
    """A frame that declares or decodes to more than max_size raises before the
    memory is taken."""
    data = bytes(1 << 20)
    declared = zstandard.ZstdCompressor(level=3).compress(data)
    co = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = co.compress(data) + co.flush()
    for frame in (declared, streamed):
        assert zstd.decompress(frame, max_size=1 << 20) == data
        with pytest.raises(ValueError):
            zstd.decompress(frame, max_size=1000)


def test_codec_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No compiler, or a failed build, raises: there is no fallback."""
    from novic_tpu_torch.ops import build

    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        build.build_host(bad)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        build.build_host(bad)
    assert not list((tmp_path / "out").glob("*"))


@settings(max_examples=150, deadline=None, database=None)
@given(data=st.binary(max_size=4000), level=st.sampled_from([1, 3, 19]))
def test_zstd_hypothesis_bytes(data, level):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
    assert zstd.decompress(frame) == data
    assert zstd.decompress(zstd.compress_raw(data)) == data


@pytest.mark.parametrize("name", ["text", "float32", "int_pattern"])
def test_zstd_truncated_and_flipped_frames_raise(name):
    data = _inputs()[name]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    rng = np.random.default_rng(1)
    for cut in sorted(set(rng.integers(0, len(frame), 60).tolist())):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])
    raised = 0
    for _ in range(400):
        flipped = bytearray(frame)
        pos = int(rng.integers(6, len(frame)))  # past the frame header's descriptor
        flipped[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            out = zstd.decompress(bytes(flipped))
        except ValueError:
            raised += 1
        else:
            # A bit the format ignores (an FSE table description's padding): the
            # checksum then holds, and so must the bytes
            assert out == data
    assert raised >= 390
    with pytest.raises(ValueError):
        zstd.decompress(b"\x00\x01\x02\x03 not a frame")


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65_791, 65_792, 131_072, 131_073, 700_001])
def test_zstd_raw_frames_round_trip_through_zstandard(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    frame = zstd.compress_raw(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.frame_content_size(frame) == size
    assert zstd.decompress(frame) == data
    assert len(frame) <= size + 14 + 3 * (size // 131_072 + 1)


def test_checksums():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"6789", zstd.crc32c(b"12345")) == 0xE3069283
    # A frame's XXH64 checksum, checked: its last byte changed raises
    frame = zstandard.ZstdCompressor(write_checksum=True).compress(b"checksum me" * 9)
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(frame[:-1] + bytes([frame[-1] ^ 0x40]))


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


def _items(n: int, max_value: int, seed: int):
    rng = np.random.default_rng(seed)
    return sorted((b"params.leaf_%05d/%s" % (i, b"0" * int(rng.integers(0, 4))),
                   rng.integers(0, 256, int(rng.integers(0, max_value)), dtype=np.uint8).tobytes())
                  for i in range(n))


def _tensorstore_store(path: str, items: list, commits: int, **config):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    for part in np.array_split(np.arange(len(items)), commits):
        tx = ts.Transaction()
        for i in part:
            kv.with_transaction(tx).write(items[i][0], items[i][1]).result()
        tx.commit_async().result()


OCDBT_CASES = {
    "one_leaf": (30, 80, 1, {}),
    "interior_nodes": (500, 300, 1, {"max_decoded_node_bytes": 512}),
    "several_commits": (300, 200, 20, {"max_decoded_node_bytes": 1024,
                                       "version_tree_arity_log2": 1}),
    "inline_0": (120, 300, 3, {"max_inline_value_bytes": 0}),
    "uncompressed": (150, 300, 2, {"compression": None, "max_decoded_node_bytes": 700}),
}


@pytest.mark.parametrize("case", sorted(OCDBT_CASES))
def test_ocdbt_reads_tensorstore_stores(tmp_path, case):
    n, max_value, commits, config = OCDBT_CASES[case]
    items = _items(n, max_value, seed=n)
    _tensorstore_store(str(tmp_path), items, commits, **config)
    with ocdbt.Reader(str(tmp_path)) as store:
        assert store.items() == items
        versions = store.versions()
        generations = [v.generation for v in versions]
        assert generations == list(range(1, len(generations) + 1))
        assert versions[-1] == store.latest and store.latest.num_keys == n
        if case == "interior_nodes":
            assert store.latest.root_height >= 2
        if case == "several_commits":
            assert len(versions) > 2 ** config["version_tree_arity_log2"]
        if case == "inline_0":
            assert all(not isinstance(v, bytes) or not v for _, v in store.entries())
        # An older generation reads as the prefix of the items it held
        if commits > 1:
            older = store.items(versions[-2])
            assert 0 < len(older) < n and set(older) <= set(items)
        assert (store.config.zstd_level is None) == (case == "uncompressed")


# The port writes one format, zstd-compressed; it reads uncompressed stores above
@pytest.mark.parametrize("case", sorted(set(OCDBT_CASES) - {"uncompressed"}))
def test_tensorstore_reads_the_ports_stores(tmp_path, case):
    n, max_value, _, config = OCDBT_CASES[case]
    items = _items(n, max_value, seed=n + 1)
    kw = {k: config[k] for k in ("max_decoded_node_bytes", "max_inline_value_bytes") if k in config}
    ocdbt.write(str(tmp_path), items, **kw)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/"}).result()
    keys = sorted(kv.list().result())
    assert [(k, kv.read(k).result().value) for k in keys] == items
    with ocdbt.Reader(str(tmp_path)) as store:
        assert store.items() == items
        assert store.latest.generation == 1 and store.latest.num_keys == n
        assert store.config.zstd_level == 0
        if case == "interior_nodes":
            assert store.latest.root_height >= 2


def test_ocdbt_refuses_corrupt_stores(tmp_path):
    items = _items(40, 300, seed=3)
    ocdbt.write(str(tmp_path), items)
    manifest = tmp_path / ocdbt.MANIFEST
    good = manifest.read_bytes()
    manifest.write_bytes(good[:-1] + bytes([good[-1] ^ 1]))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Reader(str(tmp_path))
    manifest.write_bytes(good[:-5])
    with pytest.raises(ValueError):
        ocdbt.Reader(str(tmp_path))
    manifest.write_bytes(good)
    (data,) = glob.glob(str(tmp_path / "d" / "*"))
    blob = bytearray(open(data, "rb").read())
    blob[-3] ^= 0x10  # inside the root node
    open(data, "wb").write(bytes(blob))
    with ocdbt.Reader(str(tmp_path)) as store, pytest.raises(ValueError):
        store.items()
    with pytest.raises(ValueError, match="duplicate"):
        ocdbt.write(str(tmp_path / "dup"), [(b"a", b"1"), (b"a", b"2")])


# ---------------------------------------------------------------------------
# Orbax trees and zarr v2
# ---------------------------------------------------------------------------


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"params": {"w": (rng.standard_normal((300, 257)) * 0.02).astype(np.float32),
                       "half": rng.standard_normal((5, 7)).astype(np.float16),
                       "bf": rng.standard_normal((6,)).astype(ml_dtypes.bfloat16),
                       "block": {"scale": np.array(0.25, np.float32),
                                 "ids": rng.integers(-2 ** 40, 2 ** 40, (4,), dtype=np.int64),
                                 "i32": np.arange(9, dtype=np.int32).reshape(3, 3)}},
            "opt": [np.array(7, np.int32), np.array([True, False, True]),
                    np.arange(5, dtype=np.uint8), rng.standard_normal((3, 2)).astype(np.float32)]}


def test_orbax_trees_both_ways(tmp_path):
    tree = _tree(0)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "by_orbax"), tree, force=True)
    _assert_trees_equal(orbax_format.read_tree(str(tmp_path / "by_orbax")), tree)
    orbax_format.write_tree(str(tmp_path / "by_port"), tree)
    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(str(tmp_path / "by_port"))
    assert isinstance(restored["opt"], list)
    _assert_trees_equal(restored, tree)
    # Every array opens in tensorstore as a zarr array
    for name, arr in flatten_dict({"params": tree["params"]}).items():
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                   "base": f"file://{tmp_path}/by_port/"},
                     "path": name}).result()
        assert _same(t.read().result(), arr), name
    # Writing over a checkpoint replaces it; no temporary directory is left behind
    orbax_format.write_tree(str(tmp_path / "by_port"), _tree(1))
    _assert_trees_equal(orbax_format.read_tree(str(tmp_path / "by_port")), _tree(1))
    assert sorted(os.listdir(tmp_path)) == ["by_orbax", "by_port"]


def _zarr_store(path, name: str, zarray: dict, chunks: dict):
    items = [(f"{name}/.zarray".encode(), json.dumps(zarray).encode())]
    items += [(f"{name}/{k}".encode(), v) for k, v in chunks.items()]
    ocdbt.write(path, items)
    with open(os.path.join(path, orbax_format.METADATA), "w") as f:
        json.dump({"tree_metadata": {f"('{name}',)": {
            "key_metadata": [{"key": name, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}},
            "use_ocdbt": True, "use_zarr3": False}, f)


def test_zarr_chunk_grid_edges_and_fill(tmp_path):
    """A (5, 7) array in (2, 3) chunks: partial edge chunks stored whole, one
    chunk missing (the fill value), zstd and uncompressed chunks, '/' keys."""
    arr = np.arange(35, dtype=np.float32).reshape(5, 7)
    for compressor, sep in (({"id": "zstd", "level": 3}, "."), (None, "/")):
        chunks = {}
        for i in range(3):
            for j in range(3):
                if (i, j) == (1, 2):
                    continue
                block = np.zeros((2, 3), np.float32)
                part = arr[2 * i:2 * i + 2, 3 * j:3 * j + 3]
                block[:part.shape[0], :part.shape[1]] = part
                raw = block.tobytes()
                chunks[f"{i}{sep}{j}"] = (zstandard.ZstdCompressor(level=3).compress(raw)
                                          if compressor else raw)
        path = str(tmp_path / f"grid_{sep == '/'}")
        _zarr_store(path, "a", {"zarr_format": 2, "shape": [5, 7], "chunks": [2, 3],
                                "dtype": "<f4", "compressor": compressor, "fill_value": -1.5,
                                "order": "C", "filters": None, "dimension_separator": sep},
                    chunks)
        want = arr.copy()
        want[2:4, 6:7] = -1.5
        got = orbax_format.read_tree(path)["a"]
        assert _same(got, want)
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}/"},
                     "path": "a"}).result()
        assert _same(t.read().result(), want)


@pytest.mark.parametrize("change,match", [
    ({"order": "F"}, "order"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, "blosc"),
    ({"dtype": "<c8"}, "dtype"),
    ({"zarr_format": 3}, "zarr_format"),
])
def test_zarr_refusals_name_what_is_unsupported(tmp_path, change, match):
    zarray = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
              "compressor": None, "fill_value": None, "order": "C", "filters": None}
    _zarr_store(str(tmp_path), "a", {**zarray, **change}, {"0": bytes(8)})
    with pytest.raises(ValueError, match=match):
        orbax_format.read_tree(str(tmp_path))


@pytest.mark.parametrize("shape,chunks,compressed", [
    ([1 << 40], [1 << 40], False),  # far more than its one stored chunk holds
    ([1 << 34], [1 << 34], True),  # more than a zstd frame of its size can decode to
    ([1 << 30], [1], False),  # one chunk stored, the rest would be fill
])
def test_zarr_shape_larger_than_its_data_is_refused(tmp_path, shape, chunks, compressed):
    raw = np.arange(2, dtype=np.float32).tobytes()
    zarray = {"zarr_format": 2, "shape": shape, "chunks": chunks, "dtype": "<f4",
              "compressor": {"id": "zstd", "level": 1} if compressed else None,
              "fill_value": None, "order": "C", "filters": None}
    _zarr_store(str(tmp_path), "a", zarray,
                {"0": zstandard.ZstdCompressor().compress(raw) if compressed else raw})
    with pytest.raises(ValueError, match="declares shape"):
        orbax_format.read_tree(str(tmp_path))


def test_orbax_zarr3_is_refused(tmp_path):
    tree = {"a": np.arange(3, dtype=np.float32)}
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "z3"), tree, force=True)
    meta_path = tmp_path / "z3" / orbax_format.METADATA
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr3"):
        orbax_format.read_tree(str(tmp_path / "z3"))


# ---------------------------------------------------------------------------
# Whole checkpoints, the decoder, the fixture
# ---------------------------------------------------------------------------


def _jax_meta_args(cfg: JConfig):
    tok = j_make_test_tokenizer(FIXTURE_NOUNS)
    tc = j_create_target_config(tok, FIXTURE_NOUNS, with_start_token=False, with_end_token=True,
                                compact_ids=True, fixed_token_length=False,
                                auto_fixed_token_length=True, use_masks=True)
    return dict(cfg_flat={"embedder": "test:24", "seed": 3}, model_config=cfg, target_config=tc,
                data_config={"multi_target": False}, target_nouns=tuple(FIXTURE_NOUNS),
                num_invalid_target_nouns=0)


def fixture_tree(seed: int = 19) -> tuple[dict, list]:
    """The fixture's params and optimizer leaves: mixed dtypes, a 0-d array, a
    nested dict, and a 160 KiB float32 array of bfloat16 values (two zstd
    blocks of Huffman-coded literals when orbax compresses it)."""
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((160, 256)) * 0.02).astype(ml_dtypes.bfloat16)
              .astype(np.float32),
              "pattern": np.tile(np.arange(64, dtype=np.int32), 40).reshape(40, 64),
              "half": rng.standard_normal((8, 16)).astype(np.float16),
              "bf": rng.standard_normal((16,)).astype(ml_dtypes.bfloat16),
              "scale": np.array(0.5, np.float32),
              "block": {"inner": {"bytes": rng.integers(0, 256, (7,), dtype=np.uint8),
                                  "mask": rng.random(5) > 0.5,
                                  "ids": rng.integers(-2 ** 40, 2 ** 40, (3,), dtype=np.int64)}}}
    opt = [np.array(3, np.int32), rng.standard_normal((4, 4)).astype(np.float32),
           np.zeros((16,), np.float32)]
    return params, opt


def write_fixture(directory: str) -> tuple[str, str]:
    """The fixture written by novic_tpu's savers: (orbax directory, .npz twin)."""
    params, opt = fixture_tree()
    kw = dict(params=params, opt_state_arrays=opt, train_meta={"chunk_id": 2},
              **_jax_meta_args(JConfig(embed_dim=24, vocab_size=50, token_length=5, hidden_dim=32,
                                       num_layers=2, num_heads=4)))
    orbax_dir = os.path.join(directory, "orbax_small.orbax")
    npz = os.path.join(directory, "orbax_small.npz")
    jckpt.save_checkpoint_orbax(orbax_dir, **kw)
    jckpt.save_checkpoint(npz, **kw)
    return orbax_dir, npz


def test_fixture_matches_its_npz_twin():
    size = sum(os.path.getsize(p) for p in glob.glob(f"{FIXTURE}/**", recursive=True)
               if os.path.isfile(p))
    assert size < 300_000
    assert NOVICModel._peek_embedder_spec(FIXTURE) == "test:24"
    ck, twin = checkpoint.load_checkpoint(FIXTURE), checkpoint.load_checkpoint(FIXTURE_NPZ)
    _assert_checkpoints_equal(ck, twin)
    params, opt = fixture_tree()
    _assert_trees_equal(ck["params"], params)
    _assert_trees_equal(ck["opt_arrays"], opt)
    # Real orbax bytes: per-process stores and compressed frames of every kind
    assert os.path.isdir(os.path.join(FIXTURE, "ocdbt.process_0"))
    with ocdbt.Reader(FIXTURE) as store:
        chunk = dict(store.items())[b"params.w/0.0"]
    assert chunk[:4] == b"\x28\xb5\x2f\xfd" and len(chunk) < params["w"].nbytes


def test_fixture_rebuilds(tmp_path):
    orbax_dir, npz = write_fixture(str(tmp_path))
    _assert_checkpoints_equal(checkpoint.load_checkpoint(orbax_dir),
                              checkpoint.load_checkpoint(FIXTURE))
    _assert_checkpoints_equal(checkpoint.load_checkpoint(npz),
                              checkpoint.load_checkpoint(FIXTURE_NPZ))


def test_jax_orbax_checkpoint_loads_in_the_port_and_back(tmp_path):
    params, opt = fixture_tree(seed=5)
    kw = dict(params=params, opt_state_arrays=opt, train_meta={"loop_state": {"chunk_id": 4}},
              **_jax_meta_args(JConfig(embed_dim=24, vocab_size=50, token_length=5, hidden_dim=32,
                                       num_layers=2, num_heads=4)))
    jckpt.save_checkpoint_orbax(str(tmp_path / "jax.orbax"), **kw)
    port = checkpoint.load_checkpoint(str(tmp_path / "jax.orbax"))
    _assert_checkpoints_equal(port, jckpt.load_checkpoint(str(tmp_path / "jax.orbax")))
    assert port["model_config"].as_dict() == kw["model_config"].as_dict()
    assert port["target_nouns"] == tuple(FIXTURE_NOUNS)
    # ...and the port's save is read by novic_tpu, bit for bit, meta and all
    checkpoint.save_checkpoint_orbax(
        str(tmp_path / "port.orbax"), params=port["params"], cfg_flat=port["cfg_flat"],
        model_config=port["model_config"], target_config=port["target_config"],
        data_config=port["data_config"], target_nouns=port["target_nouns"],
        num_invalid_target_nouns=port["num_invalid_target_nouns"],
        opt_state_arrays=port["opt_arrays"], train_meta=port["train_meta"])
    back = jckpt.load_checkpoint(str(tmp_path / "port.orbax"))
    _assert_checkpoints_equal(back, port)
    assert back["model_config"] == kw["model_config"]
    assert back["target_config"].as_jsonable() == kw["target_config"].as_jsonable()
    assert "ocdbt.process_0" not in os.listdir(tmp_path / "port.orbax")


def test_decoder_from_a_jax_orbax_checkpoint_matches_jax(tmp_path):
    jcfg = JConfig(embed_dim=24, vocab_size=50, token_length=5, hidden_dim=32, num_layers=2,
                   num_heads=4, matmul_precision="highest")
    jmodel = JDecoder(cfg=jcfg)
    embed = np.random.default_rng(1).normal(size=(3, 24)).astype(np.float32)
    params = jmodel.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(embed),
                         jnp.zeros((3, 5), jnp.int32))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05, params)
    jckpt.save_checkpoint_orbax(str(tmp_path / "dec.orbax"), params=params,
                                **_jax_meta_args(jcfg))
    ck = checkpoint.load_checkpoint(str(tmp_path / "dec.orbax"))
    model = decoder_from_numpy(ck["model_config"], ck["params"])
    jl, _, _ = jmodel.bind({"params": params}).prefill_split(jnp.asarray(embed))
    with torch.no_grad():
        logits, _, _ = model.prefill_split(torch.from_numpy(embed))
    jl = np.asarray(jl)
    assert np.abs(logits.numpy() - jl).max() <= RTOL * np.abs(jl).max()


# ---------------------------------------------------------------------------
# Both CLIs, and serving from a directory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from test_torch_train_cli import NOUNS, _write

    from novic_tpu_torch.data.cache import EmbeddingCacheWriter
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.text.target import TargetTokenizer, create_target_config

    d = tmp_path_factory.mktemp("orbax_cli")
    with open(d / "vocab.json", "w") as f:
        json.dump([{"target_noun": n} for n in NOUNS], f)
    _write(EmbeddingCacheWriter, make_test_tokenizer, create_target_config, TargetTokenizer,
           str(d / "cache.bin"), 1, False)
    return d


def _args(d, out: str) -> list[str]:
    # tests/test_cli.py's orbax test sizes
    return ["embedder=test:32", f"vocab_path={d}/vocab.json", "seed=1", f"output_dir={d}/{out}",
            f"embedding_dataset={d}/cache.bin", "batch_size=8", "hidden_dim=32", "num_layers=2",
            "num_heads=4", "mlp_seq_len=2", "input_dropout=0.0", "layer_dropout=0.0",
            "init_lr=3e-3", "chunk_scale=4", "save_top1_min=200", "strict_embedder=false"]


def _losses(d, out: str) -> list:
    (run,) = glob.glob(f"{d}/{out}/ovod_*")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [(m.get("chunk_loss"), m["loss"], m["top1"], m["grad_norm_max"])
                for m in map(json.loads, f)]


def _npz_twin(load, save, src: str, dst: str):
    """`src` (an .orbax directory) as a .npz, through one package's loader and saver."""
    ck = load(src)
    save(dst, params=ck["params"], cfg_flat=ck["cfg_flat"], model_config=ck["model_config"],
         target_config=ck["target_config"], data_config=ck["data_config"],
         target_nouns=ck["target_nouns"], num_invalid_target_nouns=ck["num_invalid_target_nouns"],
         opt_state_arrays=ck["opt_arrays"], train_meta=ck["train_meta"])


def test_jax_cli_orbax_checkpoint_resumes_in_the_port(workdir):
    jax_main(["action=train", "max_chunks=2", "save_every_max=2", "checkpoint_format=orbax"]
             + _args(workdir, "jax_orbax"))
    (src,) = glob.glob(f"{workdir}/jax_orbax/ovod_*/*.orbax")
    os.makedirs(f"{workdir}/jax_twin")
    twin = f"{workdir}/jax_twin/{os.path.basename(src)[:-6]}.npz"
    _npz_twin(jckpt.load_checkpoint, jckpt.save_checkpoint, src, twin)
    runs = {}
    for label, path in (("orbax", src), ("npz", twin)):
        state, S, _ = main(["action=train", "max_chunks=3", "save_every_max=100",
                            f"load_model={path}", "--device=cpu"]
                           + _args(workdir, f"port_from_{label}"))
        runs[label] = (S.chunk_id, state.step, _losses(workdir, f"port_from_{label}"),
                       {n: p.detach().numpy() for n, p in state.model.named_parameters()})
    (c1, s1, l1, p1), (c2, s2, l2, p2) = runs["orbax"], runs["npz"]
    assert (c1, s1) == (c2, s2) == (4, 12) and l1 == l2 and len(l1) == 1
    for n in p1:
        np.testing.assert_array_equal(p1[n], p2[n])


def test_port_cli_orbax_checkpoint_resumes_in_jax(workdir):
    state, S, _ = main(["action=train", "max_chunks=2", "save_every_max=2",
                        "checkpoint_format=orbax", "--device=cpu"] + _args(workdir, "port_orbax"))
    (src,) = glob.glob(f"{workdir}/port_orbax/ovod_*/*.orbax")
    assert os.path.isdir(src) and os.path.isfile(os.path.join(src, "novic_meta.json"))
    ck = checkpoint.load_checkpoint(src)
    named = dict(state.model.named_parameters())
    for n, v in flatten_dict(ck["params"]).items():
        np.testing.assert_array_equal(v, named[n].detach().numpy())
    os.makedirs(f"{workdir}/port_twin")
    twin = f"{workdir}/port_twin/{os.path.basename(src)[:-6]}.npz"
    _npz_twin(checkpoint.load_checkpoint, checkpoint.save_checkpoint, src, twin)
    runs = {}
    for label, path in (("orbax", src), ("npz", twin)):
        jstate, jS, _ = jax_main(["action=train", "max_chunks=3", "save_every_max=100",
                                  f"load_model={path}"] + _args(workdir, f"jax_from_{label}"))
        runs[label] = (jS.chunk_id, _losses(workdir, f"jax_from_{label}"),
                       flatten_dict(jax.tree.map(np.asarray, jstate.params)))
    (c1, l1, p1), (c2, l2, p2) = runs["orbax"], runs["npz"]
    assert c1 == c2 == 4 and l1 == l2 and len(l1) == 1
    for n in p1:
        np.testing.assert_array_equal(p1[n], p2[n])

    # The port serves the directory: the spec from its novic_meta.json, and the
    # labels and logprobs of its .npz twin
    assert NOVICModel._peek_embedder_spec(src) == "test:32"
    assert NOVICModel._peek_embedder_spec(twin) == "test:32"
    embeds = np.random.default_rng(4).normal(size=(4, 32)).astype(np.float32)
    outs = []
    for path in (src, twin):
        with NOVICModel(path, gencfg="beam_k10_vnone_gn_t1_a0", batch_size=4,
                        device="cpu") as model:
            outs.append(model.classify_embeds(embeds))
    assert outs[0].preds == outs[1].preds and outs[0].logprobs == outs[1].logprobs
    with pytest.raises(FileNotFoundError):
        NOVICModel._peek_embedder_spec(f"{workdir}/missing.orbax")


if __name__ == "__main__":
    # Rewrite the committed fixture (tests/data/orbax_small.orbax and .npz)
    for path in (FIXTURE, FIXTURE_NPZ):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    os.makedirs(DATA, exist_ok=True)
    print(write_fixture(DATA), file=sys.stderr)
