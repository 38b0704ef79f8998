"""The program's spans and counters, recorded only while a torch.profiler
session is active.

    with trace.span("decode", rows=256):
        ...
    trace.count("decode.steps")

A span records its name, `t0` and `t1` on `time.perf_counter()` (the clock
of a benchmark's own host spans), the thread it ran on, its attributes, its
`id`, its `parent` (the id of the innermost span open on the same thread,
None at the top) and a sequence id `seq`: a top-level span draws a new one
and every span under it shares it. Records stay in memory in a bounded list;
past MAX_RECORDS they are dropped and counted (`dropped()`), never raised.
They belong to the newest session: the start of a profiler session clears
the records and counters of the one before, so a long-lived process holds
one session's records at most, and every session records from an empty list.

Whether to record is read from torch.autograd.profiler's process-wide flag,
which torch.profiler sets while a session runs, so a loader's producer thread
records too (torch's own `_profiler_enabled()` answers for the calling thread
only). With no session, `span` returns one shared no-op context and `count`
returns at once: nothing is recorded or kept. While recording, a span also
enters `torch.profiler.record_function(name)`, so a profiler's trace shows the
program's spans as user annotations on the clock of its kernels; for a thread
the profiler does not follow, only this module records the span.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

from torch.autograd import profiler as _autograd_profiler

MAX_RECORDS = 1 << 16

_records: list[dict] = []
_counters: dict[str, float] = {}
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_seqs = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


def active() -> bool:
    """True while a torch.profiler session runs, on any thread."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "seq", "t0", "annotation")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent: Optional[_Span] = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.seq = parent.seq if parent is not None else next(_seqs)
        stack.append(self)
        self.annotation = _autograd_profiler.record_function(self.name)
        self.annotation.__enter__()
        # The span times the work it wraps: its own bookkeeping, and the first
        # record_function of a session (a millisecond of set-up), stay outside
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.annotation.__exit__(*exc)
        _local.stack.pop()
        _append({"name": self.name, "t0": self.t0, "t1": t1, "id": self.id,
                  "parent": self.parent, "seq": self.seq, "thread": threading.get_ident(),
                  "attrs": self.attrs})
        return False


def _append(record: dict) -> None:
    global _dropped
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(record)
        else:
            _dropped += 1


def span(name: str, **attrs):
    """A context that records `name` from entry to exit while a profiler runs."""
    if not active():
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: float = 1) -> None:
    """Add n to the counter `name` while a profiler runs."""
    if not active():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def records() -> list[dict]:
    """The spans recorded so far, in the order they closed."""
    with _lock:
        return list(_records)


def counters() -> dict[str, float]:
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """Spans not kept since the last clear because the list was full."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0


def _on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    """torch.autograd.profiler calls this as every session starts, before it
    sets the flag that `active()` reads."""
    clear()
    start()


_autograd_profiler._run_on_profiler_start = _on_profiler_start
