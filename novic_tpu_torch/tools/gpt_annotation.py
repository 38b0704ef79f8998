"""GPT-4o-class automatic annotation of predictions (offline tooling, L7).

Capability parity with reference gpt_annotation.py: each (image, predicted
noun) pair is judged by a vision LLM into one of the categories
correct_primary / correct_secondary / close_primary / close_secondary /
incorrect, with stateful multi-opinion voting: at least MIN_OPINIONS (3)
opinions are gathered, more (up to MAX_OPINIONS=5) if the vote confidence is
below CONFIDENCE (0.78). Supports a live API driver and an OpenAI Batch API
driver (JSONL request construction + resumable state file); the pure voting /
batching logic is importable and tested without the openai package.

Output annotation schema (ref train.py:4197-4230): {sample: {category: [nouns]}}.

The port's copy of novic_tpu.tools.gpt_annotation, with the same
functions and names. It runs no kernel and touches no device.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import json
import os
import time
from typing import Optional, Sequence

from novic_tpu_torch.utils.logger import log

CATEGORIES = ("correct_primary", "correct_secondary", "close_primary",
              "close_secondary", "incorrect")
MIN_OPINIONS = 3
MAX_OPINIONS = 5
CONFIDENCE = 0.78

ANNOTATION_PROMPT = (
    "You are verifying open-vocabulary image classifications. Given the image and the "
    "candidate label '{noun}', answer with exactly one of: correct_primary (label names "
    "the main subject precisely), correct_secondary (correct but for a secondary object), "
    "close_primary (near-miss for the main subject), close_secondary (near-miss for a "
    "secondary object), incorrect.")


@dataclasses.dataclass
class OpinionState:
    """Voting state for one (sample, noun) pair (ref gpt_annotation.py voting)."""

    opinions: list[str] = dataclasses.field(default_factory=list)

    def add(self, category: str):
        if category not in CATEGORIES:
            raise ValueError(f"Invalid category: {category}")
        self.opinions.append(category)

    @property
    def votes(self) -> collections.Counter:
        return collections.Counter(self.opinions)

    @property
    def leader(self) -> Optional[str]:
        votes = self.votes
        return votes.most_common(1)[0][0] if votes else None

    @property
    def confidence(self) -> float:
        if not self.opinions:
            return 0.0
        return self.votes.most_common(1)[0][1] / len(self.opinions)

    @property
    def decided(self) -> bool:
        """Need ≥ MIN_OPINIONS; gather more (to MAX_OPINIONS) while confidence
        is below the threshold."""
        n = len(self.opinions)
        if n < MIN_OPINIONS:
            return False
        if n >= MAX_OPINIONS:
            return True
        return self.confidence >= CONFIDENCE

    @property
    def needs_opinion(self) -> bool:
        return not self.decided


def build_batch_requests(pairs: Sequence[tuple[str, str]], model: str = "gpt-4o",
                         detail: str = "low") -> list[dict]:
    """(image_path, noun) pairs → OpenAI Batch API JSONL request objects
    (ref gpt_annotation.py batch driver)."""
    requests = []
    for i, (image_path, noun) in enumerate(pairs):
        requests.append({
            "custom_id": f"{os.path.basename(image_path)}::{noun}::{i}",
            "method": "POST",
            "url": "/v1/chat/completions",
            "body": {
                "model": model,
                "max_tokens": 8,
                "messages": [{
                    "role": "user",
                    "content": [
                        {"type": "text", "text": ANNOTATION_PROMPT.format(noun=noun)},
                        {"type": "image_url",
                         "image_url": {"url": f"file://{image_path}", "detail": detail}},
                    ],
                }],
            },
        })
    return requests


def parse_category(response_text: str) -> Optional[str]:
    text = response_text.strip().lower()
    for category in CATEGORIES:
        if category in text:
            return category
    return None


def finalize_annotations(states: dict[tuple[str, str], OpinionState]) -> dict[str, dict[str, list[str]]]:
    """Voting states → annotation JSON schema {sample: {category: [nouns]}}."""
    out: dict[str, dict[str, list[str]]] = {}
    for (sample, noun), state in states.items():
        leader = state.leader
        if leader is None:
            continue
        out.setdefault(sample, {}).setdefault(leader, []).append(noun)
    return out


class AnnotationDriver:
    """Live-API annotation with resumable state (requires openai + key)."""

    def __init__(self, state_path: str, model: str = "gpt-4o"):
        self.state_path = state_path
        self.model = model
        self.states: dict[tuple[str, str], OpinionState] = {}
        if os.path.exists(state_path):
            with open(state_path) as f:
                raw = json.load(f)
            for key, opinions in raw.items():
                sample, noun = key.split("::", 1)
                self.states[(sample, noun)] = OpinionState(opinions=list(opinions))
            log.info(f"Resumed annotation state with {len(self.states)} pairs")

    def save(self):
        raw = {f"{s}::{n}": st.opinions for (s, n), st in self.states.items()}
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(raw, f)
        os.replace(tmp, self.state_path)

    def annotate(self, pairs: Sequence[tuple[str, str]], sleep: float = 0.2):
        try:
            import openai
        except ImportError:
            raise RuntimeError("gpt annotation requires the openai package "
                               "(offline tooling; not available in this environment)")
        client = openai.OpenAI()
        backoff = 1.0
        for image_path, noun in pairs:
            key = (os.path.basename(image_path), noun)
            state = self.states.setdefault(key, OpinionState())
            while state.needs_opinion:
                try:
                    with open(image_path, "rb") as f:
                        b64 = base64.b64encode(f.read()).decode()
                    resp = client.chat.completions.create(
                        model=self.model, max_tokens=8,
                        messages=[{"role": "user", "content": [
                            {"type": "text", "text": ANNOTATION_PROMPT.format(noun=noun)},
                            {"type": "image_url",
                             "image_url": {"url": f"data:image/jpeg;base64,{b64}",
                                           "detail": "low"}}]}])
                    category = parse_category(resp.choices[0].message.content)
                    if category:
                        state.add(category)
                    backoff = 1.0
                    time.sleep(sleep)
                except Exception as e:  # noqa: BLE001 — exponential backoff on API errors
                    log.warning(f"Annotation API error: {e}")
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 600)
            self.save()

    def export(self, out_path: str):
        """action_save_classes equivalent: write the final annotation JSON."""
        annotations = finalize_annotations(self.states)
        with open(out_path, "w") as f:
            json.dump(annotations, f, indent=2, sort_keys=True)
        log.info(f"Wrote {sum(len(v) for v in annotations.values())} annotations: {out_path}")


def estimate_batch_cost(num_pairs: int, opinions: int = MIN_OPINIONS,
                        tokens_per_request: int = 1100,
                        usd_per_mtoken: float = 2.5) -> float:
    """Rough cost estimate for a batch run (ref gpt_annotation.py cost estimation)."""
    return num_pairs * opinions * tokens_per_request * usd_per_mtoken / 1e6


# ---------------------------------------------------------------------------
# OpenAI Batch API lifecycle (ref gpt_annotation.py:299-397 action_annotate_batch,
# :792-855 send_batch, :857-960 wait_for_batch, :479-500 BackoffWaiter)
# ---------------------------------------------------------------------------

MIB = 1024 * 1024
TERMINAL_BATCH_STATUSES = ("failed", "completed", "expired", "cancelled")


class BackoffWaiter:
    """Exponential backoff after a number of allowed free failures
    (ref gpt_annotation.py:479-500)."""

    def __init__(self, allowed_failures: int = 3, base_wait: float = 10.0,
                 max_wait: float = 3600.0, factor: float = 2.0,
                 sleep=time.sleep):
        assert allowed_failures >= 0 and max_wait >= base_wait > 0 and factor >= 1
        self.allowed_failures = allowed_failures
        self.base_wait = base_wait
        self.max_wait = max_wait
        self.factor = factor
        self.num_failures = 0
        self._sleep = sleep

    def update(self, success: bool) -> float:
        """Returns the wait applied (0 if none)."""
        if success:
            self.num_failures = 0
            return 0.0
        self.num_failures += 1
        over = self.num_failures - self.allowed_failures - 1
        if over < 0:
            return 0.0
        wait = min(self.base_wait * (self.factor ** over), self.max_wait)
        self._sleep(wait)
        return wait


def _estimate_request_tokens(request: dict) -> int:
    """Conservative input-token estimate for pending-token quota accounting
    (text chars/4 + nominal low-detail image cost, ref token bookkeeping)."""
    text = json.dumps(request["body"]["messages"])
    return len(text) // 4 + 100


class BatchAnnotationDriver:
    """Full OpenAI Batch API lifecycle with resumable state: chunk requests
    under request/size/token quotas, upload + launch batches, poll, download
    + process results into the opinion store, clean up remote and local
    files. The client is injectable (any object with .files.create/.content/
    .delete and .batches.create/.retrieve) so the whole round-trip is
    offline-testable; None = construct openai.OpenAI() on first use."""

    def __init__(self, state_path: str, *, model: str = "gpt-4o", client=None,
                 max_batch_requests: int = 1000, max_batch_mib: int = 90,
                 max_pending_batches: int = 4, max_pending_ktokens: int = 2000,
                 poll_interval: float = 60.0, sleep=time.sleep):
        assert max_batch_requests >= 1 and max_batch_mib >= 1
        assert max_pending_batches >= 1 and max_pending_ktokens >= 5
        self.state_path = state_path
        self.batch_dir = os.path.join(os.path.dirname(os.path.abspath(state_path)),
                                      "batches")
        self.model = model
        self._client = client
        self.max_batch_requests = max_batch_requests
        self.max_batch_size = max_batch_mib * MIB
        self.max_pending_batches = max_pending_batches
        self.max_pending_tokens = max_pending_ktokens * 1000
        self.poll_interval = poll_interval
        self._sleep = sleep
        self.backoff = BackoffWaiter(sleep=sleep)

        self.states: dict[tuple[str, str], OpinionState] = {}
        self.pending: list[dict] = []
        self.usage: dict[str, int] = {}
        if os.path.exists(state_path):
            with open(state_path) as f:
                raw = json.load(f)
            for key, opinions in raw.get("opinions", {}).items():
                sample, noun = key.split("::", 1)
                self.states[(sample, noun)] = OpinionState(opinions=list(opinions))
            self.pending = list(raw.get("pending", []))
            self.usage = dict(raw.get("usage", {}))
            log.info(f"Resumed batch state: {len(self.states)} pairs, "
                     f"{len(self.pending)} pending batches")

    # -- state ----------------------------------------------------------------

    @property
    def client(self):
        if self._client is None:
            import openai

            self._client = openai.OpenAI()
        return self._client

    def save(self):
        raw = {
            "opinions": {f"{s}::{n}": st.opinions for (s, n), st in self.states.items()},
            "pending": self.pending,
            "usage": self.usage,
        }
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(raw, f, indent=1, sort_keys=True)
        os.replace(tmp, self.state_path)

    def _pending_tokens(self) -> int:
        return sum(p["num_tokens"] for p in self.pending)

    def _pending_bytes(self) -> int:
        return sum(p["json_file_size"] for p in self.pending)

    # -- submit ---------------------------------------------------------------

    def _needed_requests(self, pairs: Sequence[tuple[str, str]]) -> list[dict]:
        """One request per missing opinion for every undecided pair, skipping
        opinions already in flight in pending batches."""
        # custom_id format: "<sample>::<noun>::<seq>" — count per (sample, noun)
        in_flight: collections.Counter = collections.Counter()
        for p in self.pending:
            for cid in p["custom_ids"]:
                sample, noun, _ = cid.split("::")
                in_flight[(sample, noun)] += 1
        requests = []
        seq = 0
        for image_path, noun in pairs:
            sample = os.path.basename(image_path)
            state = self.states.setdefault((sample, noun), OpinionState())
            if state.decided:
                missing = 0
            elif len(state.opinions) < MIN_OPINIONS:
                missing = MIN_OPINIONS - len(state.opinions)  # top up to the minimum
            else:
                missing = 1  # undecided past the minimum: one more opinion
            missing = max(missing - in_flight[(sample, noun)], 0)
            for _ in range(missing):
                req = build_batch_requests([(image_path, noun)], model=self.model)[0]
                req["custom_id"] = f"{sample}::{noun}::{seq}"
                seq += 1
                requests.append(req)
        return requests

    def submit(self, pairs: Sequence[tuple[str, str]]) -> int:
        """Chunk needed requests under the quotas and launch batches; blocks
        (polling) when pending quota caps are hit. Returns batches launched."""
        os.makedirs(self.batch_dir, exist_ok=True)
        requests = self._needed_requests(pairs)
        launched = 0
        chunk: list[dict] = []
        chunk_bytes = chunk_tokens = 0
        for req in requests:
            line_bytes = len((json.dumps(req) + "\n").encode())
            n_tok = _estimate_request_tokens(req)
            if chunk and (len(chunk) >= self.max_batch_requests
                          or chunk_bytes + line_bytes > self.max_batch_size
                          or chunk_tokens + n_tok > self.max_pending_tokens):
                self._send_batch(chunk, chunk_bytes, chunk_tokens)
                launched += 1
                chunk, chunk_bytes, chunk_tokens = [], 0, 0
            chunk.append(req)
            chunk_bytes += line_bytes
            chunk_tokens += n_tok
        if chunk:
            self._send_batch(chunk, chunk_bytes, chunk_tokens)
            launched += 1
        return launched

    def _send_batch(self, requests: list[dict], jsonl_size: int, num_tokens: int):
        """Upload one JSONL + launch one remote batch (ref send_batch). Blocks
        on the pending-batch / pending-token quotas first."""
        assert num_tokens <= self.max_pending_tokens
        while (len(self.pending) >= self.max_pending_batches
               or self._pending_tokens() + num_tokens > self.max_pending_tokens):
            if not self.poll_once():
                self._sleep(self.poll_interval)

        name = f"batch_{time.strftime('%Y%m%d_%H%M%S')}_{len(self.pending)}_{abs(hash(requests[0]['custom_id'])) % 10000:04d}.jsonl"
        local = os.path.join(self.batch_dir, name)
        with open(local, "w", encoding="utf-8") as f:
            for req in requests:
                f.write(json.dumps(req) + "\n")
        try:
            with open(local, "rb") as f:
                remote_file = self.client.files.create(file=f, purpose="batch")
            try:
                remote_batch = self.client.batches.create(
                    completion_window="24h", endpoint="/v1/chat/completions",
                    input_file_id=remote_file.id,
                    metadata={"action": "annotate_batch", "local": name})
            except Exception:
                self._delete_remote(remote_file.id, "batch JSONL")
                raise
        except Exception:
            os.unlink(local)
            raise
        self.pending.append({
            "remote_batch": remote_batch.id,
            "remote_json_file_id": remote_file.id,
            "json_file": name,
            "json_file_size": jsonl_size,
            "num_tokens": num_tokens,
            "custom_ids": [r["custom_id"] for r in requests],
        })
        self.save()
        log.info(f"Launched batch {remote_batch.id}: {len(requests)} requests, "
                 f"{jsonl_size / MIB:.1f} MiB, ~{num_tokens / 1000:.1f}k tokens")

    # -- poll / process ---------------------------------------------------------

    def _delete_remote(self, file_id: str, name: str):
        try:
            self.client.files.delete(file_id)
        except Exception as e:  # noqa: BLE001 — cleanup is best-effort
            log.warning(f"Could not delete remote {name} {file_id}: {e}")

    def poll_once(self) -> int:
        """Check every pending batch; process + clean up the finished ones.
        Returns how many finished (ref wait_for_batch)."""
        done = []
        for idx, p in enumerate(self.pending):
            try:
                remote = self.client.batches.retrieve(batch_id=p["remote_batch"])
            except Exception as e:  # noqa: BLE001 — transient API errors retry next poll
                log.warning(f"Batch retrieve failed for {p['remote_batch']}: {e}")
                self.backoff.update(False)
                continue
            if remote.status not in TERMINAL_BATCH_STATUSES:
                continue
            if remote.status != "completed":
                log.error(f"Batch {remote.id} finished with status {remote.status}: "
                          f"{getattr(remote, 'errors', None)}")
            content = []
            if getattr(remote, "output_file_id", None):
                try:
                    text = self.client.files.content(file_id=remote.output_file_id).text
                    content = [json.loads(line) for line in text.splitlines() if line]
                except Exception as e:  # noqa: BLE001
                    log.error(f"Could not download batch output {remote.id}: {e}")
            done.append((idx, remote, content))

        for idx, remote, content in done:
            p = self.pending[idx]
            ok = 0
            for response in content:
                try:
                    cid = response["custom_id"]
                    if cid not in set(p["custom_ids"]):
                        raise ValueError(f"Unknown custom_id {cid}")
                    sample, noun, _ = cid.split("::")
                    body = response["response"]["body"]
                    category = parse_category(
                        body["choices"][0]["message"]["content"])
                    if category:
                        self.states.setdefault((sample, noun), OpinionState()).add(category)
                        ok += 1
                    usage = body.get("usage", {})
                    for k, v in usage.items():
                        if isinstance(v, int):
                            self.usage[k] = self.usage.get(k, 0) + v
                    self.usage["requests"] = self.usage.get("requests", 0) + 1
                except (KeyError, ValueError, TypeError, IndexError) as e:
                    log.warning(f"Bad batch response line: {e}")
            if content and ok < 0.8 * len(p["custom_ids"]):
                self.backoff.update(False)
            else:
                self.backoff.update(True)
            if getattr(remote, "output_file_id", None):
                self._delete_remote(remote.output_file_id, "output JSONL")
            if getattr(remote, "error_file_id", None):
                self._delete_remote(remote.error_file_id, "errors JSONL")
            self._delete_remote(p["remote_json_file_id"], "batch JSONL")
            local = os.path.join(self.batch_dir, p["json_file"])
            if os.path.exists(local):
                os.unlink(local)

        for idx in sorted((i for i, _, _ in done), reverse=True):
            del self.pending[idx]
        if done:
            self.save()
            tok_in = self.usage.get("prompt_tokens", 0)
            tok_out = self.usage.get("completion_tokens", 0)
            log.info(f"Processed {len(done)} finished batches; usage: "
                     f"reqs={self.usage.get('requests', 0)}, in={tok_in}, out={tok_out}")
        return len(done)

    def run(self, pairs: Sequence[tuple[str, str]], max_rounds: int = 1000) -> None:
        """Submit + drain until every pair is decided (resumable at any point)."""
        for _ in range(max_rounds):
            self.submit(pairs)
            while self.pending:
                if not self.poll_once():
                    self._sleep(self.poll_interval)
            undecided = [k for k, st in self.states.items() if st.needs_opinion]
            if not undecided:
                break
            log.info(f"{len(undecided)} pairs still undecided => next round")
        self.save()

    def export(self, out_path: str):
        annotations = finalize_annotations(self.states)
        with open(out_path, "w") as f:
            json.dump(annotations, f, indent=2, sort_keys=True)
        log.info(f"Wrote {sum(len(v) for v in annotations.values())} annotations: {out_path}")


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="GPT auto-annotation of predictions")
    p.add_argument("--predictions", required=True, help="predictions.json from action=infer")
    p.add_argument("--state", required=True, help="resumable opinion state JSON")
    p.add_argument("--out", required=True, help="output annotation JSON")
    p.add_argument("--model", default="gpt-4o")
    a = p.parse_args()
    with open(a.predictions) as f:
        preds = json.load(f)
    pairs = []
    for model_out in preds["models"].values():
        for gout in model_out["gencfgs"].values():
            for key, top in zip(preds["keys"], gout["pred"]):
                pairs.append((key, top[0]))
    driver = AnnotationDriver(a.state, model=a.model)
    driver.annotate(pairs)
    driver.export(a.out)
