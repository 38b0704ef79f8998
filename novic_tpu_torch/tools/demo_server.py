"""Local live-demo server for NOVIC on PyTorch (the port's copy of
novic_tpu.tools.demo_server; the reference's hosted Hugging Face Spaces demo,
ref README.md:18-24).

A self-contained stdlib HTTP server in front of the port's NOVICModel on an
explicit device (CUDA by default): no third-party web framework, works in
air-gapped deployments. Concurrent requests with the same gencfg coalesce
into one classify_images call (MicroBatcher), padded to the model's
batch_size, so a group of K images costs one tower forward and one decode.

Endpoints:
    GET  /                          HTML page (upload box + sample gallery)
    GET  /healthz                   liveness JSON
    GET  /samples                   JSON list of sample image names
    GET  /sample/<name>             raw sample image bytes
    POST /classify?gencfg=...       body = raw image bytes -> predictions JSON
    POST /classify_sample?name=...  classify a sample image -> predictions JSON

Two behaviours are kept as novic_tpu has them, so that both packages answer
alike: `--batch_size 0` means "unset" (the model batch becomes max_batch),
and a failed group retries member by member, up to len(group) + 1 calls.
novic_tpu's main() also points JAX's persistent compile cache at
$NOVIC_JAX_CACHE; the port compiles nothing per shape, so it has no
counterpart.

Usage:
    python -m novic_tpu_torch.tools.demo_server --checkpoint ovod.npz \
        --image_dir demo/ --port 8000 --device cuda
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

log = logging.getLogger("novic")

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")
MAX_UPLOAD_BYTES = 32 << 20

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>NOVIC demo</title>
<style>
 body {{ font-family: sans-serif; max-width: 60em; margin: 2em auto; }}
 #drop {{ border: 2px dashed #888; border-radius: 8px; padding: 2em; text-align: center; }}
 #preds td {{ padding: 0.2em 0.8em; }}
 .sample {{ height: 96px; margin: 4px; cursor: pointer; border-radius: 4px; }}
 #spin {{ display: none; }}
</style></head><body>
<h1>NOVIC &mdash; open-vocabulary image classifier</h1>
<p>Checkpoint: <code>{checkpoint}</code> &middot; embedder: <code>{embedder}</code>
 &middot; generation: <code>{gencfg}</code></p>
<div id="drop">Drop an image here or <input type="file" id="file" accept="image/*"></div>
<p id="spin">classifying&hellip;</p>
<table id="preds"></table>
<div id="gallery"></div>
<script>
async function show(resp) {{
  document.getElementById('spin').style.display = 'none';
  const t = document.getElementById('preds');
  if (!resp.ok) {{ t.innerHTML = '<tr><td>error: ' + (await resp.text()) + '</td></tr>'; return; }}
  const out = await resp.json();
  let rows = '<tr><th>prediction</th><th>probability</th><th>type</th></tr>';
  for (let i = 0; i < out.preds[0].length; i++)
    rows += `<tr><td><b>${{out.preds[0][i]}}</b></td>` +
            `<td>${{out.probs[0][i].toFixed(4)}}</td><td>${{out.types[0][i]}}</td></tr>`;
  rows += `<tr><td colspan=3><small>${{out.ms.toFixed(1)}} ms</small></td></tr>`;
  t.innerHTML = rows;
}}
async function classify(file) {{
  document.getElementById('spin').style.display = 'block';
  show(await fetch('/classify', {{method: 'POST', body: file}}));
}}
document.getElementById('file').addEventListener('change', e => classify(e.target.files[0]));
const drop = document.getElementById('drop');
drop.addEventListener('dragover', e => e.preventDefault());
drop.addEventListener('drop', e => {{ e.preventDefault(); classify(e.dataTransfer.files[0]); }});
fetch('/samples').then(r => r.json()).then(names => {{
  const g = document.getElementById('gallery');
  for (const n of names) {{
    const img = document.createElement('img');
    img.src = '/sample/' + encodeURIComponent(n); img.className = 'sample'; img.title = n;
    img.onclick = async () => {{
      document.getElementById('spin').style.display = 'block';
      show(await fetch('/classify_sample?name=' + encodeURIComponent(n), {{method: 'POST'}}));
    }};
    g.appendChild(img);
  }}
}});
</script></body></html>
"""


class MicroBatcher:
    """Request coalescing for concurrent serving: requests that arrive while
    an inference batch is running queue up, and the next leader thread drains
    up to max_batch SAME-gencfg requests into one classify_images call
    (padded to the model's batch_size by its GenerationTask).

    The reference serves its demo strictly one request at a time (hosted
    Spaces app). On the card a decode costs about the same for any batch up
    to the padded size (it is bound by kernel launches), so coalescing
    multiplies concurrent throughput. Oldest-first group selection prevents
    cross-gencfg starvation."""

    def __init__(self, model, lock: threading.Lock, max_batch: int = 8):
        self.model = model
        self.lock = lock           # the model lock (shared with warm-up)
        self.max_batch = max(int(max_batch), 1)
        self.mutex = threading.Lock()
        self.queue: list[dict] = []
        # Observability (read by tests/metrics): inference batches run and
        # the largest coalesced group so far
        self.batches_run = 0
        self.requests_served = 0
        self.max_group = 0

    def classify(self, image, gencfg: Optional[str]) -> dict:
        """Enqueue one image and return its row of the (possibly batched)
        NOVICOutput as a response dict. Raises the model's error if its
        group failed."""
        item = {"img": image, "g": gencfg, "ev": threading.Event(),
                "out": None, "err": None}
        with self.mutex:
            self.queue.append(item)
        while not item["ev"].is_set():
            with self.lock:  # become the leader for one batch
                with self.mutex:
                    if item["ev"].is_set() or not self.queue:
                        continue  # served while waiting for the lock
                    g0 = self.queue[0]["g"]
                    group = [it for it in self.queue if it["g"] == g0][:self.max_batch]
                    for it in group:
                        self.queue.remove(it)
                def run(members):
                    out = self.model.classify_images([it["img"] for it in members],
                                                     gencfg=g0 or None)
                    used = (self.model.task_for(g0).gencfg.name if g0
                            else self.model.gencfg.name)
                    for i, it in enumerate(members):
                        it["out"] = {"preds": [out.preds[i]],
                                     "logprobs": [out.logprobs[i]],
                                     "probs": [out.probs[i]],
                                     "types": [out.types[i]],
                                     "gencfg": used,
                                     "batched": len(members)}

                try:
                    run(group)
                except Exception:  # noqa: BLE001 — isolate the poisoned member
                    # One bad request (e.g. an image the preprocess rejects)
                    # must not fail its co-batched neighbors: retry each
                    # member singly, still under the model lock, delivering
                    # each its own result or error.
                    for it in group:
                        try:
                            run([it])
                        except Exception as e:  # noqa: BLE001
                            it["err"] = e
                finally:
                    with self.mutex:
                        self.batches_run += 1
                        self.requests_served += len(group)
                        self.max_group = max(self.max_group, len(group))
                    for it in group:
                        it["ev"].set()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]


class DemoState:
    """Shared server state: one entered NOVICModel guarded by a lock (one
    device, one task per gencfg: requests serialize at the inference call,
    coalescing into micro-batches under concurrency)."""

    def __init__(self, model, image_dir: Optional[str] = None, max_batch: int = 8):
        self.model = model
        self.image_dir = image_dir
        self.lock = threading.Lock()
        self.batcher = MicroBatcher(model, self.lock, max_batch=max_batch)

    def sample_names(self) -> list[str]:
        if not self.image_dir or not os.path.isdir(self.image_dir):
            return []
        return sorted(n for n in os.listdir(self.image_dir)
                      if n.lower().endswith(IMAGE_EXTS))

    def sample_path(self, name: str) -> Optional[str]:
        # Refuse anything that isn't a plain listed filename (path traversal)
        if not self.image_dir or os.path.basename(name) != name:
            return None
        if name not in self.sample_names():
            return None
        return os.path.join(self.image_dir, name)

    def classify_bytes(self, data: bytes, gencfg: Optional[str] = None) -> dict:
        import PIL.Image

        image = PIL.Image.open(io.BytesIO(data)).convert("RGB")
        # gencfg is a per-request parameter: NOVICModel caches one built
        # GenerationTask (with its guide tables) per canonical name, so a
        # client toggling gencfgs pays one build per distinct name and
        # never changes the behavior other clients see. Concurrent
        # same-gencfg requests coalesce into one padded inference batch
        # (MicroBatcher), so queueing time amortizes instead of stacking.
        start = time.perf_counter()
        out = self.batcher.classify(image, gencfg or None)
        out["ms"] = (time.perf_counter() - start) * 1e3
        return out


class DemoHandler(BaseHTTPRequestHandler):
    state: DemoState  # injected by create_server

    # -- plumbing -------------------------------------------------------------

    def log_message(self, fmt, *args):
        log.debug("demo: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _error(self, code: int, msg: str):
        self._send(code, msg.encode(), "text/plain")

    def _query(self) -> dict:
        q = urllib.parse.urlsplit(self.path).query
        return {k: v[0] for k, v in urllib.parse.parse_qs(q).items()}

    def _route(self) -> str:
        return urllib.parse.urlsplit(self.path).path

    # -- GET ------------------------------------------------------------------

    def do_GET(self):
        route = self._route()
        st = self.state
        if route == "/":
            import html

            m = st.model
            page = _PAGE.format(checkpoint=html.escape(os.path.basename(m.checkpoint)),
                                embedder=html.escape(m.embedder.spec),
                                gencfg=html.escape(m.gencfg.name))
            self._send(200, page.encode(), "text/html; charset=utf-8")
        elif route == "/healthz":
            self._json({"ok": True, "gencfg": st.model.gencfg.name})
        elif route == "/samples":
            self._json(st.sample_names())
        elif route.startswith("/sample/"):
            name = urllib.parse.unquote(route[len("/sample/"):])
            path = st.sample_path(name)
            if path is None:
                return self._error(404, f"unknown sample: {name}")
            with open(path, "rb") as f:
                data = f.read()
            ext = os.path.splitext(name)[1].lstrip(".").lower().replace("jpg", "jpeg")
            self._send(200, data, f"image/{ext}")
        else:
            self._error(404, f"unknown route: {route}")

    # -- POST -----------------------------------------------------------------

    def do_POST(self):
        route = self._route()
        st = self.state
        query = self._query()
        try:
            if route == "/classify":
                length = int(self.headers.get("Content-Length") or 0)
                if not 0 < length <= MAX_UPLOAD_BYTES:
                    return self._error(413, f"upload must be 1..{MAX_UPLOAD_BYTES} bytes")
                data = self.rfile.read(length)
            elif route == "/classify_sample":
                path = st.sample_path(query.get("name", ""))
                if path is None:
                    return self._error(404, f"unknown sample: {query.get('name')}")
                with open(path, "rb") as f:
                    data = f.read()
            else:
                return self._error(404, f"unknown route: {route}")
            self._json(st.classify_bytes(data, gencfg=query.get("gencfg")))
        except (ValueError, OSError) as e:  # bad gencfg name, undecodable image
            self._error(400, str(e))
        except Exception as e:  # pragma: no cover - defensive
            log.exception("demo: classify failed")
            self._error(500, f"{type(e).__name__}: {e}")


def create_server(model, *, image_dir: Optional[str] = None, host: str = "127.0.0.1",
                  port: int = 8000, max_batch: int = 8) -> ThreadingHTTPServer:
    """Build the HTTP server around an already-entered NOVICModel. The caller
    owns the model lifecycle; serve with .serve_forever() and stop with
    .shutdown() and .server_close(). max_batch bounds request coalescing (keep
    <= the model's batch_size so a group is one padded batch)."""
    state = DemoState(model, image_dir=image_dir, max_batch=max_batch)
    handler = type("BoundDemoHandler", (DemoHandler,), {"state": state})
    return ThreadingHTTPServer((host, port), handler)


def main(argv: Optional[Sequence[str]] = None):
    from novic_tpu_torch.infer import NOVICModel

    p = argparse.ArgumentParser(description="NOVIC local live demo server")
    p.add_argument("--checkpoint", required=True,
                   help="decoder checkpoint (.npz/.train/orbax dir)")
    p.add_argument("--embedder_spec", default=None, help="override the checkpoint's embedder spec")
    p.add_argument("--gencfg", default="beam_k10_vnone_gn_t1_a0")
    p.add_argument("--guide_targets_file", default=None)
    p.add_argument("--image_dir", default=None, help="directory of sample images for the gallery")
    p.add_argument("--batch_size", type=int, default=None,
                   help="model batch size (default, or 0: max_batch, so coalesced "
                        "request groups pad into one batch shape)")
    p.add_argument("--max_batch", type=int, default=8,
                   help="max concurrent requests coalesced into one inference batch")
    p.add_argument("--precompute_dir", default=None,
                   help="on-disk store for 'all'-mode decode precompute "
                        "(restart-cheap serving; models/precompute_store.py)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", help="Torch device (default cuda)")
    args = p.parse_args(argv)

    # A falsy --batch_size (0 too) means "unset", as in novic_tpu
    batch_size = args.batch_size if args.batch_size else max(args.max_batch, 1)
    model = NOVICModel(args.checkpoint, embedder_spec=args.embedder_spec, gencfg=args.gencfg,
                       batch_size=batch_size, precompute_dir=args.precompute_dir,
                       device=args.device)
    if args.guide_targets_file:
        model.set_guide_targets(guide_targets_file=args.guide_targets_file)
    with model:
        # Serve right away (health checks and the page respond immediately);
        # warm up under the state lock so the first classify request queues
        # behind it (the kernels build at their first launch)
        server = create_server(model, image_dir=args.image_dir, host=args.host,
                               port=args.port, max_batch=args.max_batch)
        log.info(f"NOVIC demo serving on http://{args.host}:{server.server_address[1]}/")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        import numpy as np

        with server.RequestHandlerClass.state.lock:
            model.classify_embeds(np.eye(1, model.embedder.embed_dim, dtype=np.float32))
        log.info("NOVIC demo warm-up classify done")
        try:
            thread.join()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
