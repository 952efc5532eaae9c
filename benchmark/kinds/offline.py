"""The ``offline`` kind: a corpus of utterances in padded batches, in a
closed loop through ``Engine.enhance_waveforms``.

Parameters (``traffic/<mix>.json``): ``utterances`` lengths, log-normal
with median ``median_s`` and ``sigma_ln`` (the quantiles
``(i + 0.5) / n``, not draws), clipped to ``[min_s, max_s]``; sorted by
length and cut into batches of ``batch``, each zero-padded to its longest
(as a caller of ``enhance_batch`` pads); ``level_rms`` of the audio;
``compare_per_batch`` rows of each batch compared with the reference:
one drawn from each of its equal parts but the last, and its longest
row.  The batches go in index order, shortest first, pass after pass, so
every window holds the same work whatever the seed (a seeded order moved
the rate by 3% from seed to seed: the window cuts a pass of unequal
batches at another place).

Span: ``offline.enhance_waveforms``, one ``Engine.enhance_waveforms`` call
(one padded batch, host copies included).  End-to-end: ``offline_xrt``.
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import audio, check
from benchmark.reference import dpdfnet_ref as ref

SPANS = ("offline.enhance_waveforms",)
PASSES = 64          # passes over the corpus, more than a window finishes


@dataclass
class Batch:
    wavs: np.ndarray            # [B, S] zero beyond each length
    lengths: np.ndarray         # [B] samples
    compare: List[int]          # rows compared with the reference


@dataclass
class Offline:
    batches: List[Batch]
    order: np.ndarray           # batch indices in the order they are sent
    sample_rate: int
    hop: int

    def valid_seconds(self, b: int) -> float:
        return float(self.batches[b].lengths.sum()) / self.sample_rate


def generate(mix: dict, cfg: dict, seed: int, device) -> Offline:
    n, bsz = int(mix["utterances"]), int(mix["batch"])
    sr = int(cfg["sample_rate"])
    nd = statistics.NormalDist(math.log(mix["median_s"]), mix["sigma_ln"])
    secs = [min(max(math.exp(nd.inv_cdf((i + 0.5) / n)), mix["min_s"]), mix["max_s"])
            for i in range(n)]
    lengths = np.array(sorted(int(round(s * sr)) for s in secs), np.int64)
    rng = np.random.default_rng(int(seed))
    per = int(mix["compare_per_batch"])
    total = sum(int(lengths[i:i + bsz].max()) * len(lengths[i:i + bsz])
                for i in range(0, n, bsz))
    flat = audio.make(1, total, sr, mix["level_rms"], seed, device)[0]
    batches, pos = [], 0
    for i in range(0, n, bsz):
        ln = lengths[i:i + bsz]
        rows, S = len(ln), int(ln.max())
        wavs = flat[pos:pos + rows * S].reshape(rows, S).copy()
        pos += rows * S
        wavs[np.arange(S)[None, :] >= ln[:, None]] = 0.0
        parts = np.array_split(np.arange(rows), min(per, rows))
        compare = [int(rng.choice(p)) for p in parts[:-1]] + [rows - 1]
        batches.append(Batch(wavs, ln, compare))
    return Offline(batches, np.tile(np.arange(len(batches)), PASSES), sr, int(cfg["hop"]))


class Driver:
    """The closed loop of padded batches."""

    def __init__(self, engine, traffic: Offline, spans):
        self.engine = engine
        self.t = traffic
        self.span = spans
        self.log: List[dict] = []
        self.kept: Dict[Tuple[int, int], np.ndarray] = {}      # (batch, row) -> output
        self.attempted = 0
        self.failed = 0

    def _run(self, b: int) -> np.ndarray:
        batch = self.t.batches[b]
        with self.span("offline.enhance_waveforms"):
            return self.engine.enhance_waveforms(batch.wavs, lengths=batch.lengths)

    def warmup(self) -> None:
        """One batch of each padded length the cycle will send."""
        seen = set()
        for b, batch in enumerate(self.t.batches):
            key = self.engine.bucket_len(batch.wavs.shape[1])
            if key not in seen:
                seen.add(key)
                self._run(b)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        self.t0 = t0
        for b in self.t.order:
            if time.perf_counter() - t0 >= seconds:
                break
            batch = self.t.batches[b]
            self.attempted += len(batch.lengths)
            a = time.perf_counter()
            y = self._run(int(b))
            e = time.perf_counter()
            done = e - t0 <= seconds
            frames = float(batch.lengths.sum()) / self.t.hop
            self.log.append({"t0": a, "t1": e, "engine_s": e - a, "in_window": done,
                             "frames": frames, "launches": [1, int(frames), 1],
                             "batch": int(b), "valid_s": self.t.valid_seconds(int(b))})
            if done:
                for r in batch.compare:
                    self.kept[(int(b), r)] = y[r, :batch.lengths[r]].copy()
        else:
            raise RuntimeError("the corpus's passes ran out inside the window")

    def end_to_end(self) -> Dict[str, float]:
        done = [c for c in self.log if c["in_window"]]
        if not done:
            return {}
        return {"offline_xrt": sum(c["valid_s"] for c in done) / (done[-1]["t1"] - self.t0)}

    def answers(self) -> Dict[Tuple[int, int], np.ndarray]:
        return self.kept

    def due(self) -> List[Tuple[int, int]]:
        """The compared answers due in the window: the sampled rows of every
        batch that completed in it."""
        return sorted({(c["batch"], r) for c in self.log if c["in_window"]
                       for r in self.t.batches[c["batch"]].compare})

    def release(self) -> None:
        self.engine = None


def planned(traffic: Offline, seconds: float) -> List[Tuple[int, int]]:
    """The answers a window compares at most: every batch's sampled rows."""
    return [(b, r) for b, batch in enumerate(traffic.batches) for r in batch.compare]


@torch.inference_mode()
def references(params, cfg: dict, traffic: Offline, keys: List[Tuple[int, int]], device,
               tf32: bool = False) -> Dict[Tuple[int, int], np.ndarray]:
    """The reference's output for each ``(batch, row)`` over the row's own
    length, from the row's samples followed by ``4 * win`` zeros (the
    model is causal up to its two frames of lookahead, so any longer
    padding gives the same samples)."""
    win = int(cfg["n_fft"])
    length = {k: int(traffic.batches[k[0]].lengths[k[1]]) for k in keys}
    out = {}
    with check.math_mode(tf32):
        for blk in check.blocks(keys, length):
            S = max(length[k] for k in blk) + 4 * win
            x = np.zeros((len(blk), S), np.float32)
            for i, (b, r) in enumerate(blk):
                x[i, :length[(b, r)]] = traffic.batches[b].wavs[r, :length[(b, r)]]
            y = ref.enhance_offline(params, cfg, torch.as_tensor(x, device=device)).cpu().numpy()
            for i, k in enumerate(blk):
                out[k] = y[i, :length[k]]
    return out
