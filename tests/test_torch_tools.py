"""The port's offline tools (novic_tpu_torch.tools: caption generation and
checking, GPT annotation with its batch driver, the annotation GUI's session,
specificity scoring) against novic_tpu's on the same inputs, over the cases of
tests/test_tools.py. Every function gives the same result in both packages;
the batch driver runs its lifecycle and resume against one fake client each."""

import json

import pytest

from novic_tpu.tools import annotate_gui as j_gui
from novic_tpu.tools import caption_check as j_check
from novic_tpu.tools import caption_generation as j_gen
from novic_tpu.tools import gpt_annotation as j_gpt
from novic_tpu.tools import specificity as j_spec
from novic_tpu_torch.tools import annotate_gui, caption_check, caption_generation, gpt_annotation
from novic_tpu_torch.tools import specificity
from test_tools import _FakeRemote


@pytest.mark.parametrize("caption,nouns,placeholder", [
    ("A dog runs in the park", ["dog"], "singular"),
    ("The dog's toy is red", ["dog"], "singular"),
    ("I saw a dog.", ["dog"], "singular"),
    ("I love my dog,", ["dog"], "singular"),
    ("A cat sits", ["dog"], "singular"),
    ("Dogma is not an animal", ["dog"], "singular"),
    ("DOG in snow", ["dog"], "singular"),
    ("Two sea lions and a sea lion", ["sea lions", "sea lion"], "plural"),
])
def test_templatize_caption_matches_jax(caption, nouns, placeholder):
    got = caption_generation.templatize_caption(caption, nouns, placeholder)
    assert got == j_gen.templatize_caption(caption, nouns, placeholder)


def test_caption_quota_state_and_templates_match_jax():
    for freq in (0, 1, 3, 10, 50):
        assert caption_generation.caption_quota(freq) == j_gen.caption_quota(freq)
        assert caption_generation.caption_quota(freq, 5, 4) == j_gen.caption_quota(freq, 5, 4)
    vocab = [{"id": 0, "target_noun": "dog", "pretty_noun": "Dog", "singulars": ["dog"],
              "plurals": ["dogs"], "singulars_freq": [2], "plurals_freq": [1]},
             {"id": 1, "target_noun": "sea lion", "pretty_noun": "Sea lion",
              "singulars": ["sea lion"], "plurals": ["sea lions"], "singulars_freq": [0],
              "plurals_freq": [3]}]
    lines = ["A dog runs", "Two dogs play", "A dog runs", "cat here", "sea lions bark"]
    states = []
    for mod in (caption_generation, j_gen):
        state = mod.prepare_state(json.loads(json.dumps(vocab)), captions_per_freq=2)
        counts = [mod.extract_templates(e, lines) for e in state]
        states.append((state, counts, [mod.noun_complete(e) for e in state]))
    assert states[0] == states[1]
    assert states[0][1][0] == (2, 1)


def test_check_captions_matches_jax(tmp_path, capsys):
    good = [{"target_noun": "dog", "singular_captions": ["A {singular} runs."],
             "plural_captions": ["Two {plural} play."]}]
    bad = [{"target_noun": "dog",
            "singular_captions": ["no placeholder", "A {singular} and {plural}.",
                                  "dup {singular}", "dup {singular}", "bad  space {singular}"],
            "plural_captions": ["ends with comma {plural},", "ünïcode {plural}"]}]
    for caps in (good, bad):
        got = caption_check.check_captions(caps)
        assert got == j_check.check_captions(caps)
    assert caption_check.check_captions(good)["issues"] == []
    assert len(caption_check.check_captions(bad)["issues"]) >= 5
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(bad))
    rc = caption_check.main(str(path))
    out = capsys.readouterr().out
    assert rc == j_check.main(str(path))
    assert out == capsys.readouterr().out


def test_opinion_voting_matches_jax():
    sequences = [["correct_primary"] * 3,
                 ["correct_primary", "incorrect", "close_primary", "incorrect", "incorrect"],
                 ["close_secondary", "close_secondary", "correct_secondary", "close_secondary"]]
    for seq in sequences:
        ours, theirs = gpt_annotation.OpinionState(), j_gpt.OpinionState()
        for cat in seq:
            for s in (ours, theirs):
                if not s.decided:
                    s.add(cat)
            assert (ours.needs_opinion, ours.decided, ours.leader, ours.confidence) == \
                (theirs.needs_opinion, theirs.decided, theirs.leader, theirs.confidence)
    for mod in (gpt_annotation, j_gpt):
        with pytest.raises(ValueError):
            mod.OpinionState().add("bogus")


def test_finalize_batch_requests_and_parsing_match_jax(tmp_path):
    img = tmp_path / "img1.jpg"
    img.write_bytes(b"\xff\xd8 not really a jpeg")
    opinions = {("img1.jpg", "dog"): ["correct_primary"] * 3,
                ("img1.jpg", "cat"): ["incorrect"] * 3,
                ("img2.jpg", "tree"): ["close_primary"] * 3}
    ann = gpt_annotation.finalize_annotations(
        {k: gpt_annotation.OpinionState(opinions=list(v)) for k, v in opinions.items()})
    assert ann == j_gpt.finalize_annotations(
        {k: j_gpt.OpinionState(opinions=list(v)) for k, v in opinions.items()})
    assert ann["img1.jpg"]["correct_primary"] == ["dog"]
    pairs = [(str(img), "dog"), ("/x/img2.jpg", "fire truck")]
    assert gpt_annotation.build_batch_requests(pairs) == j_gpt.build_batch_requests(pairs)
    for n in (1, 1000, 12345):
        assert gpt_annotation.estimate_batch_cost(n) == j_gpt.estimate_batch_cost(n)
    for text in (" Correct_Primary\n", "definitely incorrect", "no idea", "CLOSE_SECONDARY.",
                 ""):
        assert gpt_annotation.parse_category(text) == j_gpt.parse_category(text)


def _session_trace(mod, pairs, keys, resume=None):
    s = mod.AnnotationSession(pairs, json.loads(json.dumps(resume)) if resume else None)
    trace = [(s.apply_key(k), s.current, s.done) for k in keys]
    return trace, s.annotations


def test_annotation_session_matches_jax_without_a_display(tmp_path):
    pairs = [("/a/img1.jpg", "dog"), ("/a/img2.jpg", "cat"), ("/a/img3.jpg", "tree")]
    keys = ["q", "i", "u", "p", "z", "s"]
    got = _session_trace(annotate_gui, pairs, keys)
    assert got == _session_trace(j_gui, pairs, keys)
    assert got[1] == {"img1.jpg": {"correct_primary": ["dog"]},
                      "img2.jpg": {"close_secondary": ["cat"]}}
    paths = [str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")]
    for mod, path in zip((annotate_gui, j_gui), paths):
        s = mod.AnnotationSession(pairs)
        for k in keys:
            s.apply_key(k)
        s.save(path)
    assert open(paths[0]).read() == open(paths[1]).read()
    with open(paths[0]) as f:
        resumed = json.load(f)
    assert _session_trace(annotate_gui, pairs, ["w"], resumed) == \
        _session_trace(j_gui, pairs, ["w"], resumed)


def test_specificity_score_matches_jax():
    preds = {"keys": ["/d/img1.jpg", "/d/img2.jpg", "/d/img3.jpg"],
             "models": {"m": {"gencfgs": {"g": {"pred": [["dog"], ["cat"], ["owl"]],
                                                "score": [[0.0], [0.0], [0.0]],
                                                "result": [["invalid"]] * 3}}}}}
    anns = {"img1.jpg": {"correct_primary": ["dog"]}, "img2.jpg": {"close_primary": ["cat"]},
            "img3.jpg": {"incorrect": ["owl"]}}
    spec = {"dog": 0.9, "cat": 1.0, "owl": 0.5}
    scores = specificity.specificity_score(preds, anns, spec)
    assert scores == j_spec.specificity_score(preds, anns, spec)
    assert abs(scores[("m", "g")] - (1.0 * 0.9 + 0.5 * 1.0 + 0.0) / 3) < 1e-9


def test_specificity_shipped_asset_matches_jax():
    """Both packages find the one shipped asset (data/specificity_annotations.json)."""
    path = specificity.default_specificity_path()
    assert path == j_spec.default_specificity_path()
    with open(path) as f:
        spec = json.load(f)
    assert len(spec) > 5000 and spec[""] == 0.5
    assert spec["shrub"] == 0.5 and spec["flagship"] == 1
    preds = {"keys": ["/d/a.jpg", "/d/b.jpg"],
             "models": {"m": {"gencfgs": {"g": {"pred": [["shrub"], ["flagship"]],
                                                "score": [[0.0], [0.0]],
                                                "result": [["valid"], ["valid"]]}}}}}
    anns = {"a.jpg": {"correct_primary": ["shrub"]}, "b.jpg": {"correct_secondary": ["flagship"]}}
    assert specificity.specificity_score(preds, anns, spec) == \
        j_spec.specificity_score(preds, anns, spec)


def _lifecycle(mod, tmp_path):
    fake = _FakeRemote(lag=1)
    sleeps = []
    drv = mod.BatchAnnotationDriver(str(tmp_path / "state.json"), client=fake,
                                    max_batch_requests=4, max_pending_batches=2,
                                    poll_interval=0.0, sleep=sleeps.append)
    drv.run([(f"/x/img{i}.jpg", noun) for i, noun in enumerate(["dog", "cat", "apple"])])
    drv.export(str(tmp_path / "ann.json"))
    leftovers = list((tmp_path / "batches").glob("*.jsonl"))
    return (json.loads((tmp_path / "ann.json").read_text()), dict(drv.usage), len(sleeps),
            dict(fake.files_store), sorted(fake.deleted), leftovers, dict(drv.pending))


def test_batch_driver_lifecycle_matches_jax(tmp_path):
    ours = _lifecycle(gpt_annotation, tmp_path / "ours")
    theirs = _lifecycle(j_gpt, tmp_path / "theirs")
    assert ours == theirs
    ann, usage, _, files, _, leftovers, pending = ours
    assert ann == {"img0.jpg": {"correct_primary": ["dog"]},
                   "img1.jpg": {"correct_primary": ["cat"]},
                   "img2.jpg": {"correct_primary": ["apple"]}}
    assert usage["requests"] == 9 and not files and not leftovers and not pending


def _resume(mod, tmp_path):
    fake = _FakeRemote(lag=100)
    kw = dict(client=fake, max_batch_requests=100, poll_interval=0.0, sleep=lambda s: None)
    drv = mod.BatchAnnotationDriver(str(tmp_path / "state.json"), **kw)
    first = (drv.submit([("/x/a.jpg", "dog")]), len(drv.pending), drv.poll_once())
    fake.lag = 0
    drv2 = mod.BatchAnnotationDriver(str(tmp_path / "state.json"), **kw)
    second = (len(drv2.pending), drv2.submit([("/x/a.jpg", "dog")]), drv2.poll_once(),
              drv2.states[("a.jpg", "dog")].opinions)
    return first, second


def test_batch_driver_resume_matches_jax(tmp_path):
    ours = _resume(gpt_annotation, tmp_path / "ours")
    assert ours == _resume(j_gpt, tmp_path / "theirs")
    assert ours[1] == (1, 0, 1, ["correct_primary"] * 3)


def test_backoff_waiter_matches_jax():
    outcomes = [False, False, False, False, True, False] + [False] * 10
    traces = []
    for mod in (gpt_annotation, j_gpt):
        waits = []
        w = mod.BackoffWaiter(allowed_failures=2, base_wait=10, max_wait=100, factor=2.0,
                              sleep=waits.append)
        traces.append(([w.update(o) for o in outcomes], waits))
    assert traces[0] == traces[1]
    assert traces[0][0][:4] == [0.0, 0.0, 10.0, 20.0] and traces[0][1][-1] == 100.0

