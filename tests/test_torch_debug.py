"""The port's debug helpers (utils/debug.py) and trie_num_nodes against
novic_tpu's on the same inputs: check_finite returns or raises alike (the same
message, the same count of non-finite values per leaf, nested dicts, lists and
tuples of tensors and arrays), show gives the same line, and trie_num_nodes
counts the FT0 guide trie alike."""

import os

import numpy as np
import pytest
import torch

from novic_tpu.models.guide_trie import build_guide_trie as j_build_guide_trie
from novic_tpu.models.guide_trie import trie_num_nodes as j_trie_num_nodes
from novic_tpu.utils import debug as jdebug
from novic_tpu_torch.infer import load_guide_targets
from novic_tpu_torch.models.guide_trie import build_guide_trie, trie_num_nodes
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.text.target import TargetTokenizer
from novic_tpu_torch.train.checkpoint import load_checkpoint
from novic_tpu_torch.utils import debug

FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")


def _trees():
    rng = np.random.default_rng(0)
    bad = rng.normal(size=(3, 4)).astype(np.float32)
    bad[0, 1], bad[2, 3], bad[1, 0] = np.nan, np.inf, -np.inf
    half_bad = np.ones(5)
    half_bad[4] = np.nan
    finite = {"w": rng.normal(size=(2, 2)), "b": [np.arange(3), (np.float32(1.5), None)]}
    mixed = {"z": {"a": bad, "n": np.arange(4)}, "a": [1.0, (half_bad, "text")], "m": None}
    return [("finite", finite), ("mixed", mixed), ("leaf", bad), ("scalar", float("nan")),
            ("list", [np.zeros(2), bad, {"k": half_bad}])]


def _as_torch(tree):
    """The same tree with its arrays as tensors (a bf16 leaf has no numpy twin)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


def _outcome(fn, tree):
    try:
        return ("ok", fn(tree, name="params", raise_error=True))
    except FloatingPointError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("name,tree", _trees(), ids=[n for n, _ in _trees()])
def test_check_finite_matches_jax(name, tree):
    want = _outcome(jdebug.check_finite, tree)
    assert _outcome(debug.check_finite, tree) == want
    assert _outcome(debug.check_finite, _as_torch(tree)) == want
    assert (debug.check_finite(tree, raise_error=False)
            == jdebug.check_finite(tree, raise_error=False) == (want[0] == "ok"))
    if name == "mixed":
        assert want[1] == ("Non-finite values in params: ['a'][1][0]: 1/5 non-finite, "
                           "['z']['a']: 3/12 non-finite")


def test_check_finite_sees_a_bf16_tensor():
    t = torch.tensor([1.0, float("inf"), 2.0], dtype=torch.bfloat16)
    with pytest.raises(FloatingPointError, match=r"\['x'\]: 1/3 non-finite"):
        debug.check_finite({"x": t})


@pytest.mark.parametrize("array", [np.linspace(-2, 3, 12, dtype=np.float32).reshape(3, 4),
                                   np.arange(10, dtype=np.int32), np.float64(2.5),
                                   np.array([True, False])],
                         ids=["f32", "i32", "scalar", "bool"])
@pytest.mark.parametrize("prefix", ["", "logits"])
def test_show_matches_jax(array, prefix):
    want = jdebug.show(array, prefix=prefix)
    assert debug.show(array, prefix=prefix) == want
    assert debug.show(torch.as_tensor(array), prefix=prefix) == want


def test_enable_nan_debugging_traps_a_backward_nan():
    was = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.warns(UserWarning, match="SqrtBackward"), \
                pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_trie_num_nodes_matches_jax_on_the_ft0_trie():
    ck = load_checkpoint(FT0)
    nouns = ck["target_nouns"][ck["num_invalid_target_nouns"]:]
    gids, _ = load_guide_targets(TargetTokenizer(make_test_tokenizer(nouns), ck["target_config"]),
                                 nouns)
    V, G = ck["model_config"].vocab_size, ck["model_config"].token_length - 1
    n = trie_num_nodes(build_guide_trie(gids, V, G))
    assert n == j_trie_num_nodes(j_build_guide_trie(gids, V, G))
    assert n > len(gids)  # every depth's table counts
