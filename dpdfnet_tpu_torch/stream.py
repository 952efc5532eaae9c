"""Chunked real-time streaming enhancer (counterpart of ``dpdfnet_tpu.stream``).

Arbitrary chunk sizes, causal framing with one-window latency, Vorbis-COLA
overlap-add committing one hop per frame (through the native host
library's ``ola_commit`` where it builds, bit-identical to the NumPy form),
``process`` / ``flush`` / ``reset``, internal resampling, and an error on a
mid-stream sample-rate change.  The engine's exact mode runs every frame through the same op
sequence, so the output is bit-identical for every chunking; the model
state stays on the engine's device between calls.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from . import native
from .audio import ensure_sample_rate, to_mono
from .models import state as state_lib
from .utils.device import DeviceLike
from .utils.tree import tree_map2
from .zoo import DEFAULT_MODEL


class StreamEnhancer:
    """Process audio chunk by chunk while keeping the model state across
    calls.

    Args:
        model: model name (default ``"dpdfnet2"``), resolved through the zoo.
        checkpoint_path: optional custom checkpoint; overrides ``model``.
        verbose: print model resolution / download progress.
        engine: a ``runtime.engine.Engine`` to use instead of resolving
            ``model`` (then ``model``, ``checkpoint_path`` and ``device``
            are not read).
        device: the engine's device for a model resolved by name
            (``None``: cuda).
    """

    def __init__(self, model: str = DEFAULT_MODEL,
                 checkpoint_path: Optional[Union[str, Path]] = None,
                 verbose: bool = False, engine=None, device: DeviceLike = None) -> None:
        if engine is None:
            from .api import _get_engine

            engine = _get_engine(model, checkpoint_path, verbose, device=device)
        self._engine = engine
        cfg = engine.cfg
        self._model_sr: int = cfg.sample_rate
        self._win_len: int = cfg.win_len
        self._hop_size: int = cfg.hop
        self._input_sr: Optional[int] = None
        # load (and on first use build) the native library now, not on the
        # first hop of a live stream
        native.load()
        self.reset()

    # ------------------------------------------------------------------ #

    def reset(self) -> None:
        """Reset model state and internal buffers (between independent streams)."""
        self._state = self._engine.init_stream_state(batch=1)
        self._in_buf = np.zeros(0, dtype=np.float32)
        self._ola_tail = np.zeros(self._win_len - self._hop_size, dtype=np.float32)
        self._input_sr = None

    def _bind_stream_rate(self, sample_rate: Optional[int]) -> int:
        """Latch the stream's input sample rate on first use; reject changes."""
        sr = int(sample_rate) if sample_rate is not None else self._model_sr
        if self._input_sr is None:
            self._input_sr = sr
        elif sr != self._input_sr:
            raise ValueError(
                f"This stream was opened at {self._input_sr} Hz but received "
                f"a chunk at {sr} Hz. A StreamEnhancer instance handles one "
                "stream; call reset() (or use a second instance) before "
                "switching sample rates.")
        return sr

    def _emit(self, committed: np.ndarray, sr_out: int) -> np.ndarray:
        """Convert committed model-rate samples to the caller's rate."""
        if sr_out != self._model_sr:
            committed = ensure_sample_rate(committed, self._model_sr, sr_out)
        return committed.astype(np.float32, copy=False)

    def _advance(self, model_chunk: np.ndarray) -> np.ndarray:
        """Feed model-rate samples through the engine; return committed
        model-rate output (length = hop x frames completed, possibly 0)."""
        self._in_buf = np.concatenate([self._in_buf, model_chunk])
        win, hop = self._win_len, self._hop_size
        n = self._in_buf.shape[0]
        if n < win:
            return np.zeros(0, dtype=np.float32)
        T = (n - win) // hop + 1
        idx = np.arange(T)[:, None] * hop + np.arange(win)[None, :]
        frames = self._in_buf[idx][None, ...]                     # [1, T, win]

        y, self._state = self._engine.process_frames(frames, self._state)
        y = y[0]                                                  # [T, win]

        # Overlap-add at 50% overlap (win == 2*hop): each committed hop is
        # this frame's first half plus the previous frame's second half
        # (the native form updates the tail in place).
        committed = native.ola_commit(y, self._ola_tail)
        if committed is None:
            tails = np.concatenate([self._ola_tail[None], y[:-1, hop:]], axis=0)
            committed = (y[:, :hop] + tails).reshape(-1)
            self._ola_tail = y[-1, hop:].copy()
        self._in_buf = self._in_buf[T * hop:]
        return committed

    def process(self, chunk: np.ndarray, sample_rate: Optional[int] = None) -> np.ndarray:
        """Enhance a chunk; returns enhanced samples (possibly length 0).

        The first output appears once one full window has been buffered;
        thereafter each completed hop yields one hop of output.
        """
        chunk = to_mono(np.asarray(chunk, dtype=np.float32))
        if chunk.size == 0:
            return np.zeros(0, dtype=np.float32)
        sr_in = self._bind_stream_rate(sample_rate)
        committed = self._advance(ensure_sample_rate(chunk, sr_in, self._model_sr))
        return self._emit(committed, sr_in)

    # ------------------------------------------------------------------ #
    # Mid-stream checkpoint / resume.  The model state is serialized in the
    # reference's flat layout, so a stream can be handed over between this
    # package and the JAX package.
    # ------------------------------------------------------------------ #

    def save_state(self) -> dict:
        """Snapshot the complete stream state (numpy arrays)."""
        return {
            "model_state": state_lib.flatten_state(self._engine.cfg, self._state),
            "in_buf": self._in_buf.copy(),
            "ola_tail": self._ola_tail.copy(),
            "input_sr": self._input_sr,
        }

    def load_state(self, snapshot: dict) -> None:
        """Restore a snapshot from :meth:`save_state`; the stream continues
        bit-exactly from where it was saved.  Each leaf comes back at the
        dtype of the live state's leaf (bfloat16 planes with float32 DPRNN
        hiddens on the ``turbo`` tier), as the un-interrupted stream has it."""
        st = state_lib.unflatten_state(
            self._engine.cfg, snapshot["model_state"], batch=1, device=self._engine.device)
        self._state = tree_map2(lambda new, live: new.to(live.dtype), st, self._state)
        self._in_buf = np.asarray(snapshot["in_buf"], np.float32).copy()
        self._ola_tail = np.asarray(snapshot["ola_tail"], np.float32).copy()
        self._input_sr = snapshot["input_sr"]

    def flush(self) -> np.ndarray:
        """Drain the final partial window by zero-padding it to a full frame.

        The pad goes straight into the model-rate buffer, so a resampled
        stream drains too.  Returns at most one hop of enhanced audio (at
        the stream's input rate) and does not reset state.
        """
        if self._in_buf.size == 0:
            return np.zeros(0, dtype=np.float32)
        sr_out = self._input_sr if self._input_sr is not None else self._model_sr
        pad = np.zeros(self._win_len - self._in_buf.shape[0], dtype=np.float32)
        committed = self._advance(pad)
        # Only the leading hop came from real (non-padded) input.
        return self._emit(committed[: self._hop_size], sr_out)
