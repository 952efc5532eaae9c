"""Multi-stream serving: many concurrent real-time streams on one device
(counterpart of ``dpdfnet_tpu.serving``).

``MultiStreamEnhancer`` manages a fixed pool of slots whose state is one
batched dict of tensors on the engine's device.  Each slot behaves like an
independent ``StreamEnhancer`` (same buffering, COLA overlap-add, flush
and reset); one engine call per hop bucket advances every stream of that
bucket.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .audio import to_mono
from .runtime import telemetry
from .utils.device import DeviceLike
from .utils.tree import tree_map, tree_map2
from .zoo import DEFAULT_MODEL


class MultiStreamEnhancer:
    """A pool of ``capacity`` concurrent enhancement streams.

    Usage:
        pool = MultiStreamEnhancer(capacity=64, model="dpdfnet8_48khz_hr")
        sid = pool.open()
        out = pool.process(sid, chunk)
        ...
        tail = pool.flush(sid); pool.close(sid)

    ``process_many`` advances several streams with one engine call per hop
    bucket: the throughput path for a frontend that aggregates chunks
    across connections.  ``mode`` is the engine's streaming mode,
    ``"exact"`` (bit-invariant per-frame program) or ``"throughput"``.
    The model is resolved by name through the zoo (``model``,
    ``checkpoint_path``, ``verbose``, on ``device``, ``None`` meaning cuda)
    unless an ``engine`` is given.
    """

    def __init__(self, capacity: int, model: str = DEFAULT_MODEL, checkpoint_path=None,
                 verbose: bool = False, engine=None, mode: str = "exact",
                 device: DeviceLike = None) -> None:
        if mode not in ("exact", "throughput"):
            raise ValueError(f"unknown streaming mode {mode!r}")
        if engine is None:
            from .api import _get_engine

            engine = _get_engine(model, checkpoint_path, verbose, device=device)
        self._engine = engine
        self.mode = mode
        cfg = engine.cfg
        self.capacity = int(capacity)
        self._win = cfg.win_len
        self._hop = cfg.hop
        self._state = engine.init_stream_state(batch=self.capacity)
        self._in_buf: List[np.ndarray] = [np.zeros(0, np.float32)
                                          for _ in range(self.capacity)]
        self._ola_tail = np.zeros((self.capacity, self._win - self._hop), np.float32)
        self._open = [False] * self.capacity

    # ------------------------------------------------------------------ #
    # slot management
    # ------------------------------------------------------------------ #

    def open(self) -> int:
        """Acquire a free slot; returns its stream id."""
        for sid in range(self.capacity):
            if not self._open[sid]:
                self._open[sid] = True
                self._reset_slot(sid)
                return sid
        raise RuntimeError(f"all {self.capacity} stream slots are busy")

    def close(self, sid: int) -> None:
        self._check(sid)
        self._open[sid] = False

    def reset(self, sid: int) -> None:
        self._check(sid)
        self._reset_slot(sid)

    def _reset_slot(self, sid: int) -> None:
        fresh = self._engine.init_stream_state(batch=1)
        rows = torch.tensor([sid], device=self._engine.device)
        self._state = tree_map2(lambda cur, new: cur.index_copy(0, rows, new),
                                self._state, fresh)
        self._in_buf[sid] = np.zeros(0, np.float32)
        self._ola_tail[sid] = 0.0

    def _check(self, sid: int) -> None:
        if not (0 <= sid < self.capacity) or not self._open[sid]:
            raise ValueError(f"stream id {sid} is not open")

    # ------------------------------------------------------------------ #
    # processing
    # ------------------------------------------------------------------ #

    def process(self, sid: int, chunk: np.ndarray) -> np.ndarray:
        """Enhance a chunk on one stream (model sample rate)."""
        return self.process_many({sid: chunk})[sid]

    def process_many(self, chunks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Advance several streams; one engine call per hop-count bucket.

        Streams with too little buffered audio contribute no frame and
        return empty arrays.  Every bucket runs at the pool's full capacity
        (one batch shape for the pool's lifetime), so a slot's result does
        not depend on which other slots are active.

        Spans: ``pool.process_many`` over ``pool.stage`` (validate, downmix,
        append, group), then per hop bucket ``pool.frame``, ``pool.state``
        around the state's gather and its scatter (buckets of part of the
        pool), the engine's ``engine.process_frames`` and
        ``pool.overlap_add``.
        """
        with telemetry.span("pool.process_many"):
            with telemetry.span("pool.stage"):
                # Validate and downmix every chunk before touching any buffer: a
                # bad sid late in the dict must not leave earlier streams' audio
                # appended.
                staged: Dict[int, np.ndarray] = {}
                for sid, chunk in chunks.items():
                    self._check(sid)
                    staged[sid] = to_mono(np.asarray(chunk, np.float32))
                for sid, c in staged.items():
                    self._in_buf[sid] = np.concatenate([self._in_buf[sid], c])

                counts = {sid: max(0, (len(self._in_buf[sid]) - self._win) // self._hop + 1)
                          for sid in chunks}
                out: Dict[int, np.ndarray] = {sid: np.zeros(0, np.float32) for sid in chunks}
                groups: Dict[int, List[int]] = {}
                for sid, n in counts.items():
                    if n > 0:
                        groups.setdefault(n, []).append(sid)

            dev = self._engine.device
            for n, sids in sorted(groups.items()):
                # slot order does not change results (the scatter maps rows
                # back by sid); sorting lets the identity path ignore dict order
                sids = sorted(sids)
                g, gp = len(sids), self.capacity
                with telemetry.span("pool.frame"):
                    frames = np.zeros((gp, n, self._win), np.float32)
                    fidx = np.arange(n)[:, None] * self._hop + np.arange(self._win)[None, :]
                    for row, sid in enumerate(sids):
                        frames[row] = self._in_buf[sid][fidx]

                if g == gp and sids == list(range(gp)):
                    # steady serving: every slot advances, in slot order; no
                    # state gather or scatter at all
                    y, self._state = self._engine.process_frames(frames, self._state,
                                                                 mode=self.mode)
                else:
                    with telemetry.span("pool.state"):
                        idx = torch.tensor(sids + [sids[0]] * (gp - g), device=dev)
                        rows = torch.tensor(sids, device=dev)
                        sub = tree_map(lambda _, a: a.index_select(0, idx), self._state)
                    y, sub = self._engine.process_frames(frames, sub, mode=self.mode)
                    with telemetry.span("pool.state"):
                        self._state = tree_map2(
                            lambda cur, new: cur.index_copy(0, rows, new[:g]), self._state, sub)

                with telemetry.span("pool.overlap_add"):
                    for row, sid in enumerate(sids):
                        yf = y[row]                                       # [n, win]
                        tails = np.concatenate([self._ola_tail[sid][None], yf[:-1, self._hop:]],
                                               axis=0)
                        out[sid] = (yf[:, : self._hop] + tails).reshape(-1)
                        self._ola_tail[sid] = yf[-1, self._hop:]
                        self._in_buf[sid] = self._in_buf[sid][n * self._hop:]
            return out

    def flush(self, sid: int) -> np.ndarray:
        """Drain the final partial window of one stream (at most one hop)."""
        self._check(sid)
        if self._in_buf[sid].size == 0:
            return np.zeros(0, np.float32)
        pad = np.zeros(self._win - len(self._in_buf[sid]), np.float32)
        out = self.process(sid, pad)
        return out[: min(self._hop, len(out))].astype(np.float32)
