"""On-disk store of the exhaustive ('all') decode's precompute (the counterpart of
novic_tpu.models.precompute_store).

`precompute_generate_all` is host-side numpy work (guide paddings, renorm trie
tables, vocab prior corrections, alpha scales) that a serving process would
otherwise repeat at every start. This module keeps it on disk under a SHA-256
over everything the computation reads (vocab size, the gencfg's axes, the exact
guide and vocab token arrays). A writer commits through its own temporary file
(mkstemp), fsyncs it and renames it into place, so no reader sees a half-written
file under the final name.

The format version, key, file name and array names are the JAX package's, so a
store written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np

from novic_tpu_torch.models.generate import GenerateAllPrecompute
from novic_tpu_torch.utils.logger import log

FORMAT_VERSION = 1
TRIE_TABLES = ("child_tok", "child_id", "child_cnt", "node_cnt")


def _hash_update_array(h, arr: Optional[np.ndarray]) -> None:
    if arr is None:
        h.update(b"\x00<none>")
        return
    a = np.ascontiguousarray(arr)
    h.update(str(a.dtype).encode())
    h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
    h.update(a.tobytes())


def precompute_cache_key(vocab_size: int, *, length_alpha: float, vocab_per_token: bool,
                         vocab_scaler: float, guide_renorm: bool,
                         guide_targets: np.ndarray,
                         vocab_targets: Optional[np.ndarray]) -> str:
    """Content hash of every input `precompute_generate_all` reads."""
    h = hashlib.sha256()
    h.update(f"allpre|v{FORMAT_VERSION}|{vocab_size}|{length_alpha!r}|"
             f"{bool(vocab_per_token)}|{vocab_scaler!r}|{bool(guide_renorm)}|".encode())
    _hash_update_array(h, np.asarray(guide_targets))
    _hash_update_array(h, None if vocab_targets is None else np.asarray(vocab_targets))
    return h.hexdigest()[:32]


def _store_path(store_dir: str, key: str) -> str:
    return os.path.join(store_dir, f"all_precompute_{key}.npz")


def save_precompute(store_dir: str, key: str, pre: GenerateAllPrecompute) -> str:
    """Atomically persist a GenerateAllPrecompute; returns the final path."""
    os.makedirs(store_dir, exist_ok=True)
    path = _store_path(store_dir, key)
    arrays: dict[str, np.ndarray] = {
        "format_version": np.int64(FORMAT_VERSION),
        "key": np.frombuffer(key.encode(), dtype=np.uint8),
        "guide_targets": pre.guide_targets,
        "guide_paddings": pre.guide_paddings,
    }
    for name in ("guide_nodes", "vocab_scores", "alpha_scale"):
        value = getattr(pre, name)
        if value is not None:
            arrays[name] = value
    if pre.renorm_trie is not None:
        depth = len(pre.renorm_trie["child_tok"])
        arrays["trie_depth"] = np.int64(depth)
        for table in TRIE_TABLES:
            for d in range(depth):
                arrays[f"trie_{table}_{d:03d}"] = pre.renorm_trie[table][d]
    # A temporary file per writer, not per process: threads share a PID, and a
    # PID-named file would race one writer's rename against another's open
    fd, tmp = tempfile.mkstemp(dir=store_dir, prefix=f".all_precompute_{key}.tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_precompute(store_dir: str, key: str) -> Optional[GenerateAllPrecompute]:
    """Load a stored GenerateAllPrecompute, or None on a miss or an unreadable
    file (which logs a warning: the caller recomputes, as the JAX package does)."""
    path = _store_path(store_dir, key)
    if not os.path.isfile(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as data:
            if int(data["format_version"]) != FORMAT_VERSION:
                return None
            if bytes(data["key"]).decode() != key:
                raise ValueError("stored key mismatch")
            renorm_trie = None
            if "trie_depth" in data:
                depth = int(data["trie_depth"])
                renorm_trie = {table: [data[f"trie_{table}_{d:03d}"] for d in range(depth)]
                               for table in TRIE_TABLES}

            def opt(name):
                return data[name] if name in data else None

            return GenerateAllPrecompute(
                guide_targets=data["guide_targets"], guide_paddings=data["guide_paddings"],
                renorm_trie=renorm_trie, guide_nodes=opt("guide_nodes"),
                vocab_scores=opt("vocab_scores"), alpha_scale=opt("alpha_scale"))
    except Exception as e:  # noqa: BLE001 -- any unreadable file is recomputed
        log.warning(f"Ignoring unreadable precompute store file {path} "
                    f"({type(e).__name__}: {e})")
        return None
