"""The program's own spans, as the per-layer readers see them.

The port records spans at its layers' phases (``dpdfnet_tpu_torch.runtime.
telemetry``) while a ``torch.profiler`` records, as it does over a traced
run's window.  A reader takes the spans of the window's logged calls and
divides the time in some of them by the number of calls of the layer.
A program without spans of its own reads nothing.
"""

from __future__ import annotations

# the engine's calls: a live cell's process_frames, an offline cell's
# enhance_waveforms
ENGINE_CALLS = ("engine.process_frames", "engine.enhance_waveforms")


def recorded(ctx: dict) -> list:
    """The program's spans inside the window: begun at or after its start
    ``t0`` and ended by the end of the last call of its ``log`` (both
    ``time.perf_counter()`` readings); none without a logged call, or where
    the program has no telemetry."""
    if not ctx["log"]:
        return []
    try:
        from dpdfnet_tpu_torch.runtime import telemetry
    except ImportError:
        return []
    end = int(max(c["t1"] for c in ctx["log"]) * 1e9)
    return [s for s in telemetry.spans(since_s=ctx["t0"]) if s.end_ns <= end]


def ms_per_call(ctx: dict, parts, calls=ENGINE_CALLS):
    """Mean ms a call spends in the spans named ``parts`` that lie in a call
    span named in ``calls`` (its own call id), over the call spans of the
    window; ``None`` where the window recorded no call span."""
    recs = recorded(ctx)
    ids = [s.call for s in recs if s.name in calls]
    if not ids:
        return None
    inside = set(ids)
    ns = sum(s.ns for s in recs if s.name in parts and s.call in inside)
    return 1e-6 * ns / len(ids)
