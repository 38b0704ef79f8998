"""The port's demo server (novic_tpu_torch.tools.demo_server) on the CPU, in
front of the port's NOVICModel with the FT0 decoder (a float32 copy of the
asset, as novic_tpu would otherwise compute with its float16 arrays) and the
768-wide test embedder:
  * its routes, error codes (413, 400, 404) and the path-traversal refusal;
  * responses whose preds equal novic_tpu's NOVICModel.classify_images on the
    same image bytes (logprobs within 1e-4);
  * a concurrent soak (4 clients x 4 requests) that coalesces groups, with one
    undecodable upload among them answered 400 while the others succeed;
  * MicroBatcher's poisoned-member isolation (tests/test_infer.py:614).
"""

import http.client
import io
import json
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import PIL.Image
import pytest
import torch

import novic_tpu.infer as jax_infer
from novic_tpu_torch.infer import NOVICModel
from novic_tpu_torch.tools import demo_server
from novic_tpu_torch.tools.demo_server import MicroBatcher, create_server

torch.set_num_threads(2)
GENCFG = "beam_k3_vnone_gn_t1_a0"
TIMEOUT_S = 120


def _png(seed: int, size: int = 40) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def ft0_f32(tmp_path_factory):
    import os

    src = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
    path = str(tmp_path_factory.mktemp("ft0") / "ft0_f32.npz")
    with np.load(src) as data:
        np.savez(path, **{k: data[k].astype(np.float32) if data[k].dtype == np.float16
                          else data[k] for k in data.files})
    return path


@pytest.fixture(scope="module")
def server(ft0_f32, tmp_path_factory):
    """The port's server on an ephemeral port, with two gallery samples."""
    samples = tmp_path_factory.mktemp("samples")
    (samples / "a.png").write_bytes(_png(1))
    (samples / "b.png").write_bytes(_png(2))
    (samples.parent / "secret.png").write_bytes(_png(3))
    model = NOVICModel(ft0_f32, embedder_spec="test:768", gencfg=GENCFG, batch_size=4,
                       device="cpu")
    with model:
        srv = create_server(model, image_dir=str(samples), host="127.0.0.1", port=0, max_batch=4)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            yield srv, model, samples
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(TIMEOUT_S)
    assert not thread.is_alive()


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=TIMEOUT_S)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_routes_and_error_codes(server):
    srv, model, _ = server
    status, ctype, body = _request(srv, "GET", "/")
    assert status == 200 and ctype.startswith("text/html") and b"ft0_f32.npz" in body
    assert b"test:768" in body and GENCFG.encode() in body
    status, _, body = _request(srv, "GET", "/healthz")
    assert status == 200 and json.loads(body) == {"ok": True, "gencfg": GENCFG}
    status, _, body = _request(srv, "GET", "/samples")
    assert status == 200 and json.loads(body) == ["a.png", "b.png"]
    status, ctype, body = _request(srv, "GET", "/sample/a.png")
    assert status == 200 and ctype == "image/png" and body == _png(1)
    for bad in ("/sample/../secret.png", "/sample/%2E%2E%2Fsecret.png", "/sample/missing.png",
                "/sample/" + urllib.parse.quote("/etc/passwd", safe="")):
        assert _request(srv, "GET", bad)[0] == 404, bad
    assert _request(srv, "POST", "/classify_sample?name=../secret.png")[0] == 404
    assert _request(srv, "GET", "/nope")[0] == 404
    assert _request(srv, "POST", "/nope", body=b"x")[0] == 404
    assert _request(srv, "POST", "/classify", body=b"")[0] == 413
    status, _, body = _request(srv, "POST", "/classify", body=b"not an image at all")
    assert status == 400
    status, _, body = _request(srv, "POST", "/classify?gencfg=bogus", body=_png(4))
    assert status == 400


def test_responses_match_jax_classify_images(server, ft0_f32):
    srv, model, _ = server
    images = [_png(10 + i) for i in range(3)]
    got = []
    for data in images:
        status, _, body = _request(srv, "POST", "/classify", body=data)
        assert status == 200
        got.append(json.loads(body))
    status, _, body = _request(srv, "POST", "/classify_sample?name=b.png")
    assert status == 200
    got.append(json.loads(body))
    images.append(_png(2))
    pil = [PIL.Image.open(io.BytesIO(d)).convert("RGB") for d in images]
    with jax_infer.NOVICModel(ft0_f32, embedder_spec="test:768", gencfg=GENCFG,
                              batch_size=4) as jmodel:
        ref = jmodel.classify_images(pil)
    direct = model.classify_images(pil)
    for i, out in enumerate(got):
        assert out["preds"] == [ref.preds[i]] == [direct.preds[i]]
        assert out["types"] == [ref.types[i]]
        np.testing.assert_allclose(out["logprobs"][0], ref.logprobs[i], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out["probs"][0], np.exp(out["logprobs"][0]), rtol=1e-6)
        assert out["gencfg"] == GENCFG and out["ms"] > 0
    # A per-request gencfg is served by its own cached task
    status, _, body = _request(srv, "POST", "/classify?gencfg=greedy_k1_vnone_gn_t1_a0",
                               body=images[0])
    assert status == 200 and json.loads(body)["gencfg"] == "greedy_k1_vnone_gn_t1_a0"
    assert len(json.loads(body)["preds"][0]) == 1


def test_concurrent_soak_coalesces_and_isolates_a_bad_upload(server):
    """4 clients x 4 requests queue while the model lock is held, so the leader
    drains them in groups; one undecodable upload among them gets its 400."""
    srv, model, _ = server
    state = srv.RequestHandlerClass.state
    uploads = [[_png(100 + 4 * c + r) for r in range(4)] for c in range(4)]
    uploads[2][1] = b"\x89PNG\r\n\x1a\n truncated"
    expected = {}
    for row in uploads:
        for data in row:
            if data not in expected and not data.endswith(b"truncated"):
                pil = PIL.Image.open(io.BytesIO(data)).convert("RGB")
                expected[data] = model.classify_images([pil]).preds[0]
    state.batcher.max_group = 0

    def client(row):
        return [_request(srv, "POST", "/classify", body=data) for data in row]

    with state.lock:  # the requests queue behind it
        with ThreadPoolExecutor(max_workers=4) as pool:
            futures = [pool.submit(client, row) for row in uploads]
            deadline = time.monotonic() + TIMEOUT_S
            while len(state.batcher.queue) < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(state.batcher.queue) >= 4
            state.lock.release()
            try:
                results = [f.result(timeout=TIMEOUT_S) for f in futures]
            finally:
                state.lock.acquire()
    assert state.batcher.max_group > 1
    for row, res in zip(uploads, results):
        for data, (status, _, body) in zip(row, res):
            if data.endswith(b"truncated"):
                assert status == 400
            else:
                assert status == 200, body
                out = json.loads(body)
                assert out["preds"] == [expected[data]]
                assert 1 <= out["batched"] <= 4


def test_micro_batcher_isolates_poisoned_member():
    """A request whose inference fails must not fail co-batched neighbors:
    the leader retries members singly on group failure (up to len(group) + 1
    calls, as novic_tpu does), delivering each its own result or error."""

    class FakeOut:
        def __init__(self, n):
            self.preds = [[f"p{i}"] for i in range(n)]
            self.logprobs = [[-1.0]] * n
            self.probs = [[0.5]] * n
            self.types = [["correct"]] * n

    class FakeModel:
        gencfg = type("G", (), {"name": "greedy_k1_vnone_gn_t1_a0"})()
        calls = 0

        def classify_images(self, images, gencfg=None):
            FakeModel.calls += 1
            if any(img == "bad" for img in images):
                raise ValueError("poisoned image")
            return FakeOut(len(images))

    lock = threading.Lock()
    b = MicroBatcher(FakeModel(), lock, max_batch=8)
    results = {}

    def req(img):
        try:
            results[img] = ("ok", b.classify(img, None))
        except ValueError as e:
            results[img] = ("err", str(e))

    with lock:  # all four queue, then one leader takes them as one group
        threads = [threading.Thread(target=req, args=(img,)) for img in ["a", "b", "bad", "c"]]
        for t in threads:
            t.start()
        deadline = time.monotonic() + TIMEOUT_S
        while len(b.queue) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
    for t in threads:
        t.join(TIMEOUT_S)
        assert not t.is_alive()
    kinds = sorted(k for k, _ in results.values())
    assert kinds == ["err", "ok", "ok", "ok"]
    assert results["bad"] == ("err", "poisoned image")
    for img in "abc":
        assert results[img][1]["preds"][0][0].startswith("p") and results[img][1]["gencfg"]
    assert b.requests_served == 4 and b.max_group == 4
    assert FakeModel.calls == 1 + 4  # the group, then each member alone


def test_main_treats_batch_size_zero_as_unset(monkeypatch):
    """--batch_size 0 means "unset" (the model batch becomes max_batch), as in
    novic_tpu; --device reaches the model."""
    seen = {}

    class Stop(Exception):
        pass

    class FakeNOVICModel:
        def __init__(self, checkpoint, **kw):
            seen.update(kw)
            raise Stop

    import novic_tpu_torch.infer as infer

    monkeypatch.setattr(infer, "NOVICModel", FakeNOVICModel)
    for argv, want in ((["--batch_size", "0", "--max_batch", "6"], 6),
                       (["--max_batch", "5"], 5), (["--batch_size", "3"], 3)):
        with pytest.raises(Stop):
            demo_server.main(["--checkpoint", "x.npz", "--device", "cpu"] + argv)
        assert seen["batch_size"] == want and seen["device"] == "cpu"
