"""Multi-stream serving: many concurrent real-time streams on one device
(counterpart of ``dpdfnet_tpu.serving``).

``MultiStreamEnhancer`` manages a fixed pool of slots whose state is one
batched dict of tensors on the engine's device.  Each slot behaves like an
independent ``StreamEnhancer`` (same buffering, COLA overlap-add, flush
and reset); one engine call per hop bucket advances every stream of that
bucket.  The slots' host state (buffered input, overlap-add tails) is
held as pool-wide arrays, so staging, framing and overlap-add are a fixed
number of array operations per call and hop bucket, whatever the number
of streams.
"""

from __future__ import annotations

from typing import Dict

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
        # every slot's buffered input, left-aligned in its row, and its
        # length; a call's staging sizes the rows (``_fit``)
        self._buf = np.zeros((self.capacity, self._win), np.float32)
        self._fill = np.zeros(self.capacity, np.int64)
        self._slots = list(range(self.capacity))   # a call's keys when it feeds every slot in order
        self._ola_tail = np.zeros((self.capacity, self._win - self._hop), np.float32)
        self._open = np.zeros(self.capacity, bool)

    # ------------------------------------------------------------------ #
    # slot management
    # ------------------------------------------------------------------ #

    def open(self) -> int:
        """Acquire a free slot; returns its stream id."""
        free = np.flatnonzero(~self._open)
        if free.size == 0:
            raise RuntimeError(f"all {self.capacity} stream slots are busy")
        sid = int(free[0])
        self._open[sid] = True
        self._reset_slot(sid)
        return sid

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
        self._buf[sid] = 0.0
        self._fill[sid] = 0
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

    def _fit(self, need: int) -> None:
        """Size the rows to the least ``win * 2**k`` samples that hold
        ``need``: a long chunk widens them, the next call of ordinary ones
        narrows them again.  Between calls every fill is under ``win``."""
        width = self._win
        while width < need:
            width *= 2
        if width != self._buf.shape[1]:
            keep = int(self._fill.max())
            buf = np.zeros((self.capacity, width), np.float32)
            buf[:, :keep] = self._buf[:, :keep]
            self._buf = buf

    def _write(self, ix, rows: np.ndarray, at: np.ndarray, x, L: int) -> None:
        """Write ``x`` (``[len(rows), L]``: an array, or a list of chunks) at
        fill ``at`` of the slots ``rows`` (``ix``: the same slots as an
        index, a slice where it can be)."""
        if (at == at[0]).all():
            self._buf[ix, at[0]:at[0] + L] = x
        else:
            self._buf[rows[:, None], at[:, None] + np.arange(L)] = x

    def _stage(self, chunks: Dict[int, np.ndarray]):
        """Validate every sid and chunk, then append each chunk to its slot:
        1-D chunks of one length in one write, others one write per distinct
        length after ``to_mono``; a chunk that fails leaves every fill as it
        was.  Returns the slots in ``chunks``' order as an int64 array and
        as an index (``slice(None)`` when they are every slot in order)."""
        sids = list(chunks)
        if sids == self._slots:
            rows, ix, ok = np.arange(self.capacity), slice(None), self._open
        else:
            rows = ix = np.fromiter(sids, np.int64, len(sids))
            ok = (rows >= 0) & (rows < self.capacity)
            ok[ok] = self._open[rows[ok]]
        if not ok.all():
            raise ValueError(f"stream id {sids[int(np.argmin(ok))]} is not open")
        vals = list(chunks.values())
        at = self._fill[ix]
        shape = np.shape(vals[0]) if vals else ()
        if len(shape) == 1:
            L = shape[0]
            self._fit(int(at.max()) + L)
            try:
                self._write(ix, rows, at, vals, L)
            except ValueError:                      # chunks of more than one shape
                pass
            else:
                self._fill[ix] = at + L
                telemetry.count("pool.stage_lengths", 1)
                return rows, ix
        mono = [to_mono(c) for c in vals]
        lens = np.fromiter(map(len, mono), np.int64, len(mono))
        self._fit(int((at + lens).max(initial=0)))
        distinct = np.unique(lens)
        for L in distinct.tolist():
            pick = np.flatnonzero(lens == L)
            self._write(rows[pick], rows[pick], at[pick], np.stack([mono[i] for i in pick]), L)
        self._fill[ix] = at + lens
        telemetry.count("pool.stage_lengths", len(distinct))
        return rows, ix

    def process_many(self, chunks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Advance several streams; one engine call per hop-count bucket.

        Streams with too little buffered audio contribute no frame and
        return empty arrays.  Every bucket runs at the pool's full capacity
        (one batch shape for the pool's lifetime), so a slot's result does
        not depend on which other slots are active.  Every sid and chunk is
        validated before any buffer changes; each returned array is new and
        owns its samples.

        Spans: ``pool.process_many`` over ``pool.stage`` (validate, downmix,
        append, group), then per hop bucket ``pool.frame``, ``pool.state``
        around the state's gather and its scatter (buckets of part of the
        pool), the engine's ``engine.process_frames`` and
        ``pool.overlap_add``.  Counter: ``pool.stage_lengths``, the distinct
        chunk lengths staged (1: the whole stage was one write).
        """
        win, hop = self._win, self._hop
        with telemetry.span("pool.process_many"):
            with telemetry.span("pool.stage"):
                rows, staged = self._stage(chunks)
                # the frames a slot takes: the most n with (n - 1) * hop + win <= fill
                counts = (self._fill[staged] - (win - hop)) // hop
                out: Dict[int, np.ndarray] = dict.fromkeys(chunks, np.zeros(0, np.float32))
                buckets = sorted(n for n in set(counts.tolist()) if n > 0)

            dev = self._engine.device
            for n in buckets:
                # slot order does not change results (the scatter maps rows
                # back by sid); sorted, a bucket of every slot is the identity
                sids = np.sort(rows[counts == n])
                g, gp = len(sids), self.capacity
                ix = slice(None) if g == gp else sids
                with telemetry.span("pool.frame"):
                    # rows are left-aligned: frame t of every row starts at
                    # t * hop, and its last sample lies inside the row's fill
                    s0, s1 = self._buf.strides
                    view = np.ndarray((gp, n, win), np.float32, self._buf, 0, (s0, hop * s1, s1))
                    if g == gp:
                        # the buffer itself where a row is one frame: the
                        # engine copies its input before it returns
                        frames = np.ascontiguousarray(view)
                    else:
                        frames = np.zeros((gp, n, win), np.float32)
                        frames[:g] = view[sids]

                if g == gp:
                    # steady serving: every slot advances, in slot order; no
                    # state gather or scatter at all
                    y, self._state = self._engine.process_frames(frames, self._state,
                                                                 mode=self.mode)
                else:
                    with telemetry.span("pool.state"):
                        idx = torch.as_tensor(np.concatenate([sids, np.full(gp - g, sids[0])]),
                                              device=dev)
                        sel = torch.as_tensor(sids, device=dev)
                        sub = tree_map(lambda _, a: a.index_select(0, idx), self._state)
                    y, sub = self._engine.process_frames(frames, sub, mode=self.mode)
                    with telemetry.span("pool.state"):
                        self._state = tree_map2(
                            lambda cur, new: cur.index_copy(0, sel, new[:g]), self._state, sub)

                with telemetry.span("pool.overlap_add"):
                    # frame t's head plus frame t-1's tail (the slot's carried
                    # tail for t = 0), as [g, n * hop]
                    res = np.empty((g, n, hop), np.float32)
                    np.add(y[:g, 0, :hop], self._ola_tail[ix], out=res[:, 0])
                    np.add(y[:g, 1:, :hop], y[:g, :-1, hop:], out=res[:, 1:])
                    self._ola_tail[ix] = y[:g, -1, hop:]
                    self._buf[ix, :-n * hop] = self._buf[ix, n * hop:]
                    self._fill[ix] -= n * hop
                    # an array of its own per stream: a caller that keeps one
                    # stream's output does not keep the whole bucket's alive
                    out.update(zip(sids.tolist(), map(np.ndarray.copy, res.reshape(g, n * hop))))
            return out

    def flush(self, sid: int) -> np.ndarray:
        """Drain the final partial window of one stream (at most one hop)."""
        self._check(sid)
        fill = int(self._fill[sid])
        if fill == 0:
            return np.zeros(0, np.float32)
        out = self.process(sid, np.zeros(self._win - fill, np.float32))
        return out[: min(self._hop, len(out))].astype(np.float32)
