"""The port's spans and counters, recorded only while someone looks.

A span marks one phase of a call into the port (``pool.process_many``,
``engine.fetch``, ...); a counter adds up a quantity at a span's site
(``engine.h2d_bytes``, ``engine.d2h_bytes``).  Tracing is on while a
``torch.profiler`` records, or inside ``with recording():`` for a caller
who runs no profiler; there is no other switch.  Off, :func:`span` is one
flag test that returns a shared null context, and :func:`count` one flag
test that returns: nothing reads the clock, allocates or enters the
profiler.

On, a span records its id, its parent's id (the innermost span open on
the same thread), its call id (a span with no parent opens a call, and
every span under it shares its id), its name, its start and end from
``time.perf_counter_ns()`` (the clock of ``time.perf_counter()``), its
thread and the card it was opened with (``card=``, or ``None``).  A
thread that works for another's call opens its spans inside
``with under(parent):``, ``parent`` the calling thread's :func:`current`
span, so that they are children of that span in its call.  While
a profiler records, a span is also a ``torch.profiler.record_function``
range, so that it lies on the profiler's timeline beside the device's
operations.

Records stay in memory, at most ``CAP`` spans and ``CAP`` counter
increments; those past the cap are counted as ``telemetry.dropped`` and
not stored.  :func:`spans` returns the records, :func:`snapshot` the
count, total and self time per name and the counters, :func:`reset`
clears them.  Nothing else clears them: a caller that records again and
again resets after each reading, or once the cap is reached every later
span is dropped and a later window reads nothing.

    with torch.profiler.profile() as prof:        # or: telemetry.recording()
        pool.process_many(chunks)
    print(telemetry.snapshot())
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 18
DROPPED = "telemetry.dropped"

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_calls = itertools.count(1)
_recording = 0                  # open recording() blocks, over every thread
_spans: List["Span"] = []
_counts: List[tuple] = []       # (ns, name, n)
_dropped = 0


@dataclass(frozen=True, slots=True)
class Span:
    """One recorded span; times in ``perf_counter_ns`` nanoseconds."""

    id: int
    parent: Optional[int]
    call: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    card: Optional[int] = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def enabled() -> bool:
    """Whether spans and counters record now."""
    return bool(_recording or _profiler._is_profiler_enabled)


def span(name: str, card: Optional[int] = None):
    """A context manager around one phase (on the card ``card``); the shared
    null context when tracing is off."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, card)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not (_recording or _profiler._is_profiler_enabled):
        return
    global _dropped
    t = time.perf_counter_ns()
    with _lock:
        if len(_counts) < CAP:
            _counts.append((t, name, int(n)))
        else:
            _dropped += 1


@contextlib.contextmanager
def recording():
    """Spans and counters on for the block, without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current():
    """The innermost span open on this thread, to hand to :func:`under` in
    another thread; ``None`` where none is open (tracing off included)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def under(parent):
    """A context manager in which the spans this thread opens are children
    of ``parent`` (a :func:`current` of another thread) and share its call;
    the shared null context when ``parent`` is ``None``."""
    if parent is None:
        return _NULL
    return _Under(parent)


class _Under:
    """``parent`` on this thread's stack while the block runs; never recorded."""

    __slots__ = ("parent",)

    def __init__(self, parent):
        self.parent = parent

    def __enter__(self):
        _stack().append(self.parent)
        return self.parent

    def __exit__(self, *exc):
        stack = _stack()
        if stack and stack[-1] is self.parent:
            stack.pop()
        return False


class _Open:
    """A span while it is open."""

    __slots__ = ("name", "card", "id", "parent", "call", "start", "range")

    def __init__(self, name: str, card: Optional[int]):
        self.name = name
        self.card = card

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, next(_calls)
        stack.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec = Span(self.id, self.parent, self.call, self.name, self.start, end,
                   threading.get_ident(), self.card)
        global _dropped
        with _lock:
            if len(_spans) < CAP:
                _spans.append(rec)
            else:
                _dropped += 1
        return False


def spans(since_s: Optional[float] = None) -> List[Span]:
    """The recorded spans in order of their start; with ``since_s`` (a
    ``time.perf_counter()`` reading) those that started at or after it."""
    with _lock:
        out = list(_spans)
    if since_s is not None:
        t = int(since_s * 1e9)
        out = [s for s in out if s.start_ns >= t]
    return sorted(out, key=lambda s: (s.start_ns, s.id))


def counters(since_s: Optional[float] = None) -> Dict[str, int]:
    """Each counter's sum (since ``since_s``), and ``telemetry.dropped``
    where records were dropped."""
    t = None if since_s is None else int(since_s * 1e9)
    out: Dict[str, int] = defaultdict(int)
    with _lock:
        for ns, name, n in _counts:
            if t is None or ns >= t:
                out[name] += n
        if _dropped:
            out[DROPPED] = _dropped
    return dict(out)


def self_ns(recs: List[Span]) -> Dict[int, int]:
    """Each span's own time: its duration less the part of it that its
    child spans cover (children on several threads may overlap)."""
    kids: Dict[int, list] = defaultdict(list)
    for s in recs:
        kids[s.parent].append((s.start_ns, s.end_ns))
    own = {}
    for s in recs:
        covered, end = 0, None
        for a, b in sorted(kids.get(s.id, ())):
            if end is not None and a < end:
                a = end
            if b > a:
                covered += b - a
                end = b
        own[s.id] = s.ns - covered
    return own


def snapshot(since_s: Optional[float] = None) -> dict:
    """``{"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
    {...}}`` over the spans (and counter increments) since ``since_s``."""
    recs = spans(since_s)
    own = self_ns(recs)
    names: Dict[str, Dict[str, int]] = {}
    for s in recs:
        row = names.setdefault(s.name, {"count": 0, "total_ns": 0, "self_ns": 0})
        row["count"] += 1
        row["total_ns"] += s.ns
        row["self_ns"] += own[s.id]
    return {"spans": names, "counters": counters(since_s)}


def reset() -> None:
    """Clear the recorded spans, counters and the dropped count."""
    global _dropped
    with _lock:
        _spans.clear()
        _counts.clear()
        _dropped = 0
