"""The ``live`` kind: many real-time streams in an open loop through
``MultiStreamEnhancer.process_many`` in exact mode.

Parameters (``traffic/<mix>.json``): ``streams`` streams, each handing in
one hop of ``hop_ms`` every hop, all slots open all run; ``burst`` lists
how many hops arrive together (cycled in a seeded order: ``[1]`` is a
steady stream of hops); each stream's audio is a seeded loop of
``loop_s`` seconds at ``level_rms``; ``warmup_hops`` hops run before the
window; ``compare_streams`` streams, drawn from the seed, are compared
with the reference over every hop they handed in.  A tick that finds the
loop behind hands in every hop that is due, up to ``MAX_HOPS``.

Spans: ``live.process_many``, one ``process_many`` call;
``live.process_frames``, the pool's call into the engine, through a thin
delegating wrapper of the engine that the pool is handed; ``live.wait``,
the driver waiting for the next hops to be due (asleep, then spinning for
the last ``SPIN_S``).  End-to-end: ``hop_ms.p50``, ``hop_ms.p95``, over
every hop of the window, from its due time to the return of its samples.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import audio, check
from benchmark.reference import dpdfnet_ref as ref

SPANS = ("live.process_many", "live.process_frames", "live.wait")
MAX_HOPS = 64        # most hops of one stream a call hands in

# the loop sleeps until this long before the next hops are due, then
# spins, so that hops go in when due and not when the scheduler wakes it
SPIN_S = 0.002


@dataclass
class Live:
    streams: int
    hop: int
    dt: float                    # seconds between hops
    audio: np.ndarray            # [streams, loop + margin] the loop, then its start again
    loop: int                    # samples in one loop
    bursts: np.ndarray           # hops per arrival, cycled
    warmup_hops: int
    compare: List[int]           # streams compared with the reference
    max_hops: int = MAX_HOPS     # most hops one call hands in

    def chunk(self, first_hop: int, hops: int) -> np.ndarray:
        """``[streams, hops * hop]``: hops ``first_hop`` .. of every stream."""
        off = (first_hop * self.hop) % self.loop
        return self.audio[:, off:off + hops * self.hop]

    def signal(self, stream: int, hops: int) -> np.ndarray:
        """The first ``hops`` hops of one stream, as it handed them in."""
        reps = -(-hops * self.hop // self.loop)
        return np.tile(self.audio[stream, :self.loop], reps)[:hops * self.hop]


def generate(mix: dict, cfg: dict, seed: int, device) -> Live:
    sr, hop = int(cfg["sample_rate"]), int(cfg["hop"])
    if abs(1000.0 * hop / sr - mix["hop_ms"]) > 1e-9:
        raise ValueError(f"the mix's hop of {mix['hop_ms']} ms is not the model's "
                         f"{hop} samples at {sr} Hz")
    n = int(mix["streams"])
    loop = int(round(mix["loop_s"] * sr / hop)) * hop
    base = audio.make(n, loop, sr, mix["level_rms"], seed, device)
    wav = np.tile(base, (1, 1 + -(-MAX_HOPS * hop // loop)))[:, :loop + MAX_HOPS * hop]
    rng = np.random.default_rng(int(seed))
    bursts = np.asarray(mix.get("burst", [1]), np.int64)
    bursts = np.concatenate([rng.permutation(bursts) for _ in range(max(1, 4096 // len(bursts)))])
    compare = sorted(int(s) for s in rng.choice(n, size=min(n, int(mix["compare_streams"])),
                                                replace=False))
    return Live(n, hop, hop / sr, wav, loop, bursts, int(mix["warmup_hops"]), compare)


def _wait_until(t: float) -> None:
    ahead = t - SPIN_S - time.perf_counter()
    if ahead > 0:
        time.sleep(ahead)
    while time.perf_counter() < t:
        pass


class _SpanEngine:
    """The engine as the pool sees it: every attribute delegated, and
    ``process_frames`` timed as a span."""

    def __init__(self, engine, driver):
        self._engine = engine
        self._driver = driver

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def process_frames(self, frames, st, mode: str = "exact"):
        a = time.perf_counter()
        with self._driver.span("live.process_frames"):
            out = self._engine.process_frames(frames, st, mode=mode)
        self._driver.engine_s += time.perf_counter() - a
        return out


class Driver:
    """The open loop of hops from every stream."""

    def __init__(self, engine, traffic: Live, spans):
        from dpdfnet_tpu_torch.serving import MultiStreamEnhancer

        self.t = traffic
        self.span = spans
        self.engine_s = 0.0
        self.pool = MultiStreamEnhancer(capacity=traffic.streams,
                                        engine=_SpanEngine(engine, self), mode="exact")
        self.sids = [self.pool.open() for _ in range(traffic.streams)]
        self.sent = 0                   # hops handed in per stream
        self.kept: Dict[int, List[np.ndarray]] = {s: [] for s in traffic.compare}
        self.log: List[dict] = []
        self.lat: List[float] = []      # per hop of the window, seconds after it was due
        self.attempted = 0
        self.failed = 0
        self.backlog_max = 0

    def _call(self, hops: int) -> float:
        x = self.t.chunk(self.sent, hops)
        chunks = dict(zip(self.sids, x))
        self.engine_s = 0.0
        a = time.perf_counter()
        with self.span("live.process_many"):
            out = self.pool.process_many(chunks)
        e = time.perf_counter()
        want = hops * self.t.hop if self.sent > 0 else (hops - 1) * self.t.hop
        self.failed += sum(len(out[s]) != want for s in self.sids)
        for s in self.t.compare:
            self.kept[s].append(out[s])
        self.sent += hops
        n = self.t.streams
        self.log.append({"t0": a, "t1": e, "engine_s": self.engine_s, "in_window": True,
                         "frames": float(hops * n), "launches": [n, 1, hops], "hops": hops})
        return e

    def warmup(self) -> None:
        for _ in range(self.t.warmup_hops):
            self._call(1)
        self.log.clear()
        self.failed = 0

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        self.t0 = t0
        bursts, j = self.t.bursts, 0
        due_hop = 0                     # hops of the window that have arrived
        arrivals: List[float] = []      # arrival time of each arrived hop
        done = 0
        nxt = t0 + (int(bursts[0]) - 1) * self.t.dt     # arrival time of burst j
        while True:
            now = time.perf_counter()
            while nxt <= now and nxt - t0 < seconds:
                b = int(bursts[j % len(bursts)])
                arrivals.extend([nxt] * b)
                due_hop += b
                j += 1
                nxt = t0 + (due_hop + int(bursts[j % len(bursts)]) - 1) * self.t.dt
            if done == due_hop:
                if nxt - t0 >= seconds:
                    break
                with self.span("live.wait"):
                    _wait_until(nxt)
                continue
            n = min(due_hop - done, self.t.max_hops)
            e = self._call(n)
            self.attempted += n * self.t.streams
            self.lat.extend(e - arrivals[done + i] for i in range(n))
            done += n
        self.backlog_max = max((c["hops"] for c in self.log), default=0)

    def end_to_end(self) -> Dict[str, float]:
        if not self.lat:
            return {}
        ms = np.asarray(self.lat) * 1e3
        return {"hop_ms.p50": float(np.percentile(ms, 50)),
                "hop_ms.p95": float(np.percentile(ms, 95))}

    def answers(self) -> Dict[int, np.ndarray]:
        return {s: np.concatenate(v) for s, v in self.kept.items()}

    def due(self) -> Tuple[List[int], int]:
        """The compared streams, over every hop they handed in."""
        return list(self.t.compare), self.sent

    def release(self) -> None:
        self.pool = None


def planned(traffic: Live, seconds: float) -> Tuple[List[int], int]:
    """What a window of ``seconds`` compares: the compared streams over the
    warm-up's hops and the window's."""
    return list(traffic.compare), traffic.warmup_hops + int(round(seconds / traffic.dt))


@torch.inference_mode()
def references(params, cfg: dict, traffic: Live, due: Tuple[List[int], int], device,
               tf32: bool = False) -> Dict[int, np.ndarray]:
    """The reference's committed output of each compared stream after its
    hops."""
    streams, hops = due
    out = {}
    with check.math_mode(tf32):
        for blk in check.blocks(streams, {s: 0 for s in streams}):
            x = np.stack([traffic.signal(s, hops) for s in blk])
            y = ref.enhance_stream(params, cfg, torch.as_tensor(x, device=device)).cpu().numpy()
            for i, s in enumerate(blk):
                out[s] = y[i]
    return out
