"""From a ``torch.profiler`` trace to what the per-layer metrics read.

The traced run wraps its window in ``torch.profiler.profile`` (host and
device activities) and marks the window and each call into the program
with ``record_function`` ranges, so that host spans and device
operations share one timeline.  :func:`reduce` keeps, within the window:

- every device operation (kernels, copies, sets) with its card (the
  device-side mirrors of the harness's ranges are not operations);
- each card's busy time, the union of its operations' intervals;
- the device time per operation name;
- the card's idle gaps, each named by the harness span that covers its
  middle on the host.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"

@dataclass
class Trace:
    window_s: float
    cards: List[int]
    busy_s: Dict[int, float]                       # card -> union of busy intervals
    ops: List[Tuple[str, float, float, int]]       # (name, start_s, end_s, card)
    gaps: Dict[str, float] = field(default_factory=dict)   # host span -> idle seconds

    def busy_mean_s(self) -> float:
        return sum(self.busy_s.values()) / max(1, len(self.cards))

    def time_by_name(self) -> Dict[str, float]:
        out = defaultdict(float)
        for name, a, b, _ in self.ops:
            out[name] += b - a
        return dict(out)

    def time_matching(self, needles) -> float:
        """Device seconds of the operations whose name holds one of ``needles``."""
        return sum(b - a for name, a, b, _ in self.ops if any(n in name for n in needles))


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the covered runs in order)."""
    runs: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if runs and a <= runs[-1][1]:
            if b > runs[-1][1]:
                runs[-1] = (runs[-1][0], b)
        else:
            runs.append((a, b))
    return sum(b - a for a, b in runs), runs


def reduce(events, cards: List[int], span_names) -> Optional[Trace]:
    """The window's :class:`Trace` from ``profile.events()``; ``None``
    where the trace holds no window range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = None
    host, ops = [], []
    ranges = set(span_names) | {WINDOW}
    for ev in events:
        tr = ev.time_range
        a, b = tr.start * 1e-6, tr.end * 1e-6
        if ev.device_type == cuda:
            # a record_function range is mirrored on the device's timeline
            # as an annotation: not an operation
            if ev.name not in ranges and not getattr(ev, "is_user_annotation", False):
                ops.append((ev.name, a, b, int(ev.device_index)))
        elif ev.name == WINDOW:
            window = (a, b)
        elif ev.name in span_names:
            host.append((a, b, ev.name))
    if window is None:
        return None
    w0, w1 = window
    ops = [(n, max(a, w0), min(b, w1), d) for n, a, b, d in ops if b > w0 and a < w1]
    busy, gaps = {}, defaultdict(float)
    host.sort()
    starts = [a for a, _, _ in host]
    for card in cards:
        length, runs = _union([(a, b) for _, a, b, d in ops if d == card])
        busy[card] = length
        edges = [w0] + [x for r in runs for x in r] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[_covering(host, starts, 0.5 * (a + b))] += (b - a) / len(cards)
    return Trace(w1 - w0, list(cards), busy, ops, dict(gaps))


def _covering(host, starts, t: float, depth: int = 8) -> str:
    """The innermost harness span around host time ``t`` (the shortest of
    the last ``depth`` spans begun by then that covers it), or ``between
    calls``."""
    best = None
    i = bisect.bisect_right(starts, t)
    for a, b, name in host[max(0, i - depth):i]:
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "between calls"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each at most ``top`` entries."""
    by_name = sorted(trace.time_by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s / max(1, len(trace.cards))] for n, s in by_name],
            "idle_gaps": [[n, s] for n, s in gaps]}
