"""Offline enhancement engine (counterpart of ``dpdfnet_tpu.runtime.engine``).

The offline pipeline runs on the engine's device:

1. pad ``win_len`` zeros (the reference alignment);
2. STFT as one DFT GEMM, scaled by ``wnorm``;
3. ``forward_spec`` over 112-frame segments with the state carried from
   segment to segment (live activations bounded by one segment);
4. the attenuation-limit blend with the 4-frame-shifted noisy spectrum;
5. iSTFT GEMM, then the ``2*win_len`` alignment (2-frame lookahead +
   2-frame DF delay).

A batch is padded to the least length that clears its longest row by
``win_len`` and whose frames fill whole segments (``Engine.bucket_len``).
A row-segment runs only when a valid output sample of that row depends on
it: given ``lengths``, each row runs through the segments its own length
needs (rows ordered longest first, segment ``i`` over the rows that reach
it), and the frames it skips feed only samples past its length, which the
output zeroes.

Quality tiers (``QUALITY_TIERS``, the JAX package's ``{name: (precision,
compute dtype)}``) on the card:

- ``highest`` and ``high``: float32 activations, cuBLAS / cuDNN in full
  float32 (TF32 off);
- ``fast``: float32 activations, cuBLAS / cuDNN with TF32 tensor-core math
  (10-bit mantissa, finer than the bf16 pass of the TPU's ``default``);
- ``turbo``: bfloat16 activations from the spectrum after the float32
  STFT to the network's output (convs, linears, DPRNN planes), bf16
  cuBLAS / cuDNN with float32 accumulation; the attenuation-limit blend,
  the iSTFT and the streaming FFTs run in float32.

The hand-written kernels compute in float32 FMA in every tier (bfloat16
planes in and out on ``turbo``).  Each call sets its tier's math mode for
cuBLAS / cuDNN and restores the caller's settings on the way out.

The streaming path (``init_stream_state`` / ``process_frames``) takes
sample frames ``[B, T, win]`` and returns windowed time frames ready for
overlap-add, with the state kept on the engine's device between calls.
Its programs are the JAX package's compiled streaming programs
(``_stream_fn``, ``_stream_vec_fn``, ``_stream_spec_fn``): on a CUDA engine
each is a captured ``torch.cuda.CUDAGraph`` (exact mode and the spec
program replay the captured T == 1 step once per frame, throughput mode
one graph per power-of-two bucket; threads may share the engine), on a
CPU engine the same functions run eagerly.

On a mesh (``Engine(..., mesh=parallel.mesh.make_mesh(...))``, the JAX
package's ``shard_map`` over the utterance axis) the engine holds one
replica engine per mesh device (``replicas``; the first is the engine
itself): the weights on each device, and per replica its own CUDA graphs,
graph pool, capture stream, state slots and lock.  A batch is cut into
consecutive equal shards, each shard runs its replica's single-device
path, and the outputs are gathered in order.  Offline batches are padded
with zero rows to a multiple of the mesh size; a streaming batch must be
such a multiple, and its state is the per-device form
(``parallel.mesh.Sharded``).  Every shard's work is enqueued before the
first copy back to the host, so that the devices can run side by side;
the replicas' host work runs one after another on the calling thread,
so host-bound work (the exact hop) does not overlap.  Without a mesh,
or with one device in it, the engine is its only replica and runs the
same path on the whole batch.

The engine's calls open the spans of ``runtime.telemetry`` at their phases
(the host's copies, state, replays, padding, enqueue and waits); they
record only while a ``torch.profiler`` records or inside
``telemetry.recording()``.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch

from .. import audio as audio_lib
from ..config import ModelConfig
from ..models import state as state_lib
from ..models.dpdfnet import forward_spec
from ..ops import gru_kernels
from ..ops import stft as stft_ops
from ..ops.nn import rounded
from ..ops.windows import vorbis_window
from ..parallel.mesh import Mesh, Sharded, make_mesh, shard_batch
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_leaves, tree_map
from . import telemetry

QUALITY_TIERS = {
    # name -> (matmul precision, compute dtype), as dpdfnet_tpu's table
    "highest": ("highest", None),
    "high": ("high", None),
    "fast": ("default", None),
    "turbo": ("default", "bf16"),
}
_PRECISIONS = ("highest", "high", "default")

# frames per forward_spec call in throughput mode: the JAX package's
# power-of-two ladder, so both packages split a chunk the same way
_STREAM_T_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _stream_dft_gemm() -> bool:
    """Streaming front/back DFT as the offline path's DFT / iDFT GEMMs
    instead of ``torch.fft.rfft`` / ``irfft`` (``DPDFNET_TPU_STREAM_DFT_GEMM=1``,
    default off, as in the JAX package).  Either way the op sequence per
    frame does not depend on the chunking."""
    return os.environ.get("DPDFNET_TPU_STREAM_DFT_GEMM", "0") not in ("0", "false", "False")


def _state_f32_hiddens() -> bool:
    """Carry the DPRNN inter-GRU hiddens in float32 under bf16 compute
    (``DPDFNET_TPU_STATE_F32H``, default on, read when a stream state is
    made, as in the JAX package): the kernels take and return float32
    hiddens, so a bf16 state would round them at every frame."""
    return os.environ.get("DPDFNET_TPU_STATE_F32H", "1") not in ("0", "false", "False")


def stream_graph_key(kind: str, B: int, T: int, precision: str, st) -> tuple:
    """The cache key of a captured streaming program: the JAX package's key
    (``(B, T)`` for exact mode, ``("vec", B, T)``, ``("spec", B, T)``), then
    the switches that ``forward_spec`` and its kernel wrappers read per call
    (``gru_kernels.route_key``), the stream ends' DFT switch and the state's
    leaf dtypes, so a graph captured under one setting never replays under
    another."""
    base = (B, T) if kind == "exact" else (kind, B, T)
    return base + gru_kernels.route_key(precision) + (
        _stream_dft_gemm(), tuple(leaf.dtype for _, leaf in tree_leaves(st)))


# one capture at a time in the process: ``torch.cuda.graph`` synchronizes
# the device before it captures, which another thread's capture cannot take
_CAPTURE_LOCK = threading.Lock()


class _StateSlot:
    """The static stream state of B streams that the captured graphs read
    and rewrite in place, shared by every graph of this batch and these
    leaf shapes and dtypes.  A call copies the caller's state in and hands
    a clone out: the returned state is the caller's, never the slot's."""

    def __init__(self, st):
        self.state = tree_map(lambda _, leaf: torch.empty_like(leaf), st)
        self.leaves = [leaf for _, leaf in tree_leaves(self.state)]

    def store(self, st) -> None:
        """Copy ``st`` into the slot (a leaf that shares memory with the
        slot is cloned first, so no copy reads what another overwrote)."""
        ptrs = {leaf.untyped_storage().data_ptr() for leaf in self.leaves}
        src = [leaf.clone() if leaf.untyped_storage().data_ptr() in ptrs else leaf
               for _, leaf in tree_leaves(st)]
        torch._foreach_copy_(self.leaves, src)

    def dump(self):
        """A copy of the slot's state that the caller owns."""
        return tree_map(lambda _, leaf: leaf.clone(), self.state)


def engine_from_quality(cfg, params, quality: str = "high", **kwargs):
    """Build an Engine from a named quality tier (see QUALITY_TIERS)."""
    if quality not in QUALITY_TIERS:
        raise ValueError(f"Unknown quality {quality!r}; choose from "
                         f"{sorted(QUALITY_TIERS)}")
    precision, dtype = QUALITY_TIERS[quality]
    if dtype == "bf16":
        kwargs.setdefault("compute_dtype", torch.bfloat16)
    return Engine(cfg, params, precision=precision, **kwargs)


@contextlib.contextmanager
def _math_mode(precision: str):
    """cuBLAS / cuDNN math for one engine call: TF32 on under ``"default"``
    (``fast``, ``turbo``), off otherwise (cuDNN convs default to TF32);
    bf16 GEMMs accumulate in float32.  The caller's settings come back
    on exit, so a tier never leaks into other code or engines."""
    tf32 = precision == "default"
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


@contextlib.contextmanager
def _gc_paused():
    """The cyclic garbage collector off for the block (callers hold
    ``_CAPTURE_LOCK``, so no two blocks interleave their restores)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _upload(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` (the span ``engine.upload``; the bytes that
    cross to a card count as ``engine.h2d_bytes``)."""
    with telemetry.span("engine.upload", card=device.index):
        y = x.to(device)
        if device.type != "cpu":
            telemetry.count("engine.h2d_bytes", y.nbytes)
        return y


def _host(ys) -> np.ndarray:
    """Output shards, one per replica, as one host array in mesh order (the
    span ``engine.fetch``: waiting for the devices, then the copies back,
    whose bytes from a card count as ``engine.d2h_bytes``)."""
    with telemetry.span("engine.fetch"):
        parts = [y.cpu().numpy() for y in ys]
        if ys[0].is_cuda and telemetry.enabled():
            telemetry.count("engine.d2h_bytes", sum(y.nbytes for y in ys))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


class Engine:
    """Holds params on one device, or replicated over a mesh, for one model
    configuration."""

    def __init__(self, cfg: ModelConfig, params, *, precision: str = "high",
                 compute_dtype: torch.dtype = torch.float32, seg_frames: int = 112,
                 bucket_s: float = 1.0, fuse: bool = True, device: DeviceLike = None,
                 mesh: Optional[Mesh] = None):
        if precision not in _PRECISIONS:
            raise ValueError(f"precision {precision!r}: choose from {_PRECISIONS}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        if mesh is not None:
            if device is not None and make_mesh([device]).devices[0] != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.devices[0]}; pass one or the other")
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.precision = precision
        self.compute_dtype = compute_dtype
        self._wnorm = rounded(cfg.wnorm, compute_dtype)
        # weights stay float32 on the device; bf16 compute casts them at use
        params = tree_map(lambda _, x: torch.as_tensor(x, dtype=torch.float32,
                                                       device=self.device), params)
        if fuse:
            from ..models.fuse import prepare_inference_params

            params = prepare_inference_params(params, cfg)
        self.params = params
        self.seg_frames = int(seg_frames)
        self.bucket_samples = max(cfg.hop, int(round(bucket_s * cfg.sample_rate)))
        window = vorbis_window(cfg.win_len)
        self._window_np = window
        self._window = torch.as_tensor(window, device=self.device)
        self._wss = {}                  # frames -> iSTFT divisor on the device
        # streaming programs: CUDA graphs on a card (``stream_graph_key``),
        # sharing one memory pool and one state slot per batch and dtypes;
        # one call's graph work (state in, replays, state out) at a time,
        # each after the last one's work on the device
        self._graphs = {}
        self._slots = {}
        self._graph_pool = None
        self._capture_stream = None
        self._graph_lock = threading.Lock()
        self._call_done = None
        self.graph_replays = 0          # graph replays this engine has made
        self._dft = torch.as_tensor(stft_ops.dft_matrices(cfg.win_len, window),
                                    device=self.device)
        self._idft = torch.as_tensor(stft_ops.idft_matrices(cfg.win_len, window),
                                     device=self.device)
        # the engines that run the shards after the first, in mesh order; a
        # device listed twice gets a replica of its own on the same weights
        self._others = ()
        if mesh is not None and mesh.size > 1:
            weights = {self.device: self.params}
            for d in mesh.devices[1:]:
                if d not in weights:
                    weights[d] = tree_map(lambda _, x: x.to(d), self.params)
            self._others = tuple(
                Engine(cfg, weights[d], precision=precision, compute_dtype=compute_dtype,
                       seg_frames=seg_frames, bucket_s=bucket_s, fuse=False, device=d)
                for d in mesh.devices[1:])

    @property
    def replicas(self) -> tuple:
        """The engines that run the shards of a batch, in mesh order: this
        engine, then one per further mesh entry.  Built on each read, so an
        engine holds no reference to itself and is freed (its CUDA graphs
        with it) as soon as it is dropped, never by the cyclic garbage
        collector in the middle of another engine's capture."""
        return (self,) + self._others

    def bucket_len(self, S: int) -> int:
        """Padded length for ``S`` samples: the least length, and no less
        than ``bucket_s``, that clears ``S`` by at least ``win_len`` (the
        front end pads win_len, the back end drops 2*win_len) and whose
        frames fill whole segments of ``seg_frames``: ``k * seg_frames *
        hop - hop - win_len`` samples make ``k * seg_frames`` frames.  The
        samples before ``S`` depend on those frames alone (the model is
        causal over time), so it is also the length a row of ``S`` valid
        samples needs in a longer batch."""
        cfg = self.cfg
        return (int(self._bucket_segments(S)) * self.seg_frames * cfg.hop
                - cfg.hop - cfg.win_len)

    def _bucket_segments(self, S):
        """The segments :meth:`bucket_len` pads ``S`` samples to (an int, or
        an int array of lengths)."""
        cfg = self.cfg
        need = np.maximum(np.asarray(S) + cfg.win_len, self.bucket_samples)
        return -(-(need + cfg.hop + cfg.win_len) // (self.seg_frames * cfg.hop))

    def _front(self, wav: torch.Tensor) -> torch.Tensor:
        """Pad ``win_len`` zeros, STFT as one DFT GEMM, wnorm scale:
        ``[B, S]`` -> ``[B, T, F, 2]`` at the compute dtype."""
        cfg = self.cfg
        x = torch.nn.functional.pad(wav, (0, cfg.win_len))
        spec = stft_ops.stft_matmul(x, self._window, cfg.hop, center=True, dft=self._dft)
        return self._scale_spec(spec)

    def _segment(self, spec_seg: torch.Tensor, st):
        """One ``forward_spec`` over a segment of frames from state ``st``."""
        out, st, _ = forward_spec(self.params, self.cfg, spec_seg, st,
                                  precision=self.precision)
        return out, st

    def _back(self, spec: torch.Tensor, out: torch.Tensor, alpha: float) -> torch.Tensor:
        """The attenuation-limit blend with the 4-frame-shifted noisy spec
        (alpha == 0 passes the enhanced spec through), the iSTFT GEMM and
        the ``2*win_len`` alignment; blend and iSTFT in float32."""
        cfg = self.cfg
        k = audio_lib.ATTN_LIMIT_NOISY_FRAME_OFFSET
        aligned = torch.nn.functional.pad(spec, (0, 0, 0, 0, k, 0))[:, :-k]
        out = alpha * aligned.float() + (1.0 - alpha) * out.float()
        y = stft_ops.istft_matmul(out / cfg.wnorm, self._window, cfg.hop, center=True,
                                  idft=self._idft, wss=self._window_sumsquare(out.shape[1]))
        return y[:, 2 * cfg.win_len:]

    def _window_sumsquare(self, T: int) -> torch.Tensor:
        """The iSTFT's overlap-add divisor for T frames, made once per T on
        the host and held on the device (the engine's counterpart of
        ``_dft`` / ``_idft``)."""
        wss = self._wss.get(T)
        if wss is None:
            wss = self._wss[T] = torch.as_tensor(
                stft_ops.window_sumsquare(self._window_np, T, self.cfg.hop), device=self.device)
        return wss

    def _offline(self, wav: torch.Tensor, alpha: float,
                 progress_callback: Optional[Callable[[int, int], None]] = None
                 ) -> torch.Tensor:
        """Front, the segments with the state carried from one to the next,
        back, on this engine's device, every row through every segment.
        The frames run ``seg_frames`` at a time; a last segment may be
        shorter.

        With ``progress_callback`` this is the segment-stepped path of the
        JAX package (``_run_offline_stepped``): the same calls, with
        ``progress_callback(0, T)`` first and ``progress_callback(done, T)``
        after each segment, ``done = min((i + 1) * seg_frames, T)`` (ints
        only).  Before each report one scalar of the segment is copied to
        the host, so the report follows the device and not the enqueue."""
        return self._offline_shards([wav], alpha, progress_callback)[0]

    @torch.inference_mode()
    def _offline_shards(self, wavs, alpha: float,
                        progress_callback: Optional[Callable[[int, int], None]] = None,
                        plans=None):
        """:meth:`_offline` over one shard ``[b, S]`` per replica, each on its
        replica's device: every shard's front, then segment by segment
        every shard's segment (a progress report after each segment of all
        shards), then every shard's back.  Nothing here waits for a device
        unless progress is reported, so the replicas' devices can run side
        by side.  Returns one output per shard, on its device.

        ``plans`` (from :meth:`enhance_waveforms`), one ``(order, rows)``
        per shard, schedules the row-segments: the shard's rows are taken
        in ``order`` (a device index, longest need first; ``None`` keeps
        them as they are) by one gather before the front, segment ``i``
        runs over the first ``rows[i]`` of them (the state sliced on dim 0,
        a view; a shard with no rows left launches nothing), each
        segment's output goes into the shard's output buffer, zero where no
        segment ran, and one gather after the back restores the rows'
        order.  Without ``plans`` every row runs every segment."""
        plans = plans or [(None, None)] * len(wavs)
        wavs = [w if order is None else w.index_select(0, order)
                for w, (order, _) in zip(wavs, plans)]
        specs = [rep._front(w) for rep, w in zip(self.replicas, wavs)]
        T = specs[0].shape[1]
        seg = self.seg_frames
        n_seg = -(-T // seg)
        rows = [[spec.shape[0]] * n_seg if r is None else r
                for spec, (_, r) in zip(specs, plans)]
        states = [state_lib.init_state(self.cfg, batch=r[0], dtype=spec.dtype,
                                       device=rep.device)
                  for rep, spec, r in zip(self.replicas, specs, rows)]
        outs = [torch.empty_like(spec) if min(r) == spec.shape[0]
                else torch.zeros_like(spec) for spec, r in zip(specs, rows)]
        if progress_callback is not None:
            progress_callback(0, T)
        for i in range(n_seg):
            ran = []
            for j, rep in enumerate(self.replicas):
                n = rows[j][i]
                if n == 0:
                    continue
                if i and n < rows[j][i - 1]:
                    states[j] = tree_map(lambda _, leaf: leaf[:n], states[j])
                o, states[j] = rep._segment(specs[j][:n, i * seg:(i + 1) * seg].contiguous(),
                                            states[j])
                if n_seg == 1 and n == outs[j].shape[0]:
                    outs[j] = o
                else:
                    outs[j][:n, i * seg:(i + 1) * seg] = o
                ran.append(o)
            if progress_callback is not None:
                for o in ran:
                    o[:1, -1, :1].sum().item()
                progress_callback(min((i + 1) * seg, T), T)
        ys = [rep._back(spec, o, alpha) for rep, spec, o in zip(self.replicas, specs, outs)]
        return [y if order is None else y.index_select(0, torch.argsort(order))
                for y, (order, _) in zip(ys, plans)]

    def _scale_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """The float32 spectrum at the compute dtype, times wnorm rounded to
        that dtype (the JAX package's order: cast, then scale)."""
        return spec.to(self.compute_dtype) * self._wnorm

    # ------------------------------------------------------------------ #
    # Streaming path (sample frames in, overlap-add-ready frames out)
    # ------------------------------------------------------------------ #

    def _stream_ends(self):
        """(front, back): sample frames ``[B, T, win]`` -> wnorm-scaled spec
        ``[B, T, F, 2]`` at the compute dtype, and network output spec ->
        windowed float32 time frames ``[B, T, win]``.  The rfft pair by
        default; the DFT / iDFT GEMMs (windows and irfft scaling inside the
        matrices) under ``DPDFNET_TPU_STREAM_DFT_GEMM``.  The transforms run
        in float32 (``torch.fft`` takes no bfloat16): the front casts after
        its transform, the back upcasts before its own."""
        cfg = self.cfg
        window, wnorm, F = self._window, cfg.wnorm, cfg.win_len // 2 + 1
        if _stream_dft_gemm():
            def front(frames):
                out = frames @ self._dft
                return self._scale_spec(torch.stack([out[..., :F], out[..., F:]], dim=-1))

            def back(out):
                out = out.float() / wnorm
                return torch.cat([out[..., 0], out[..., 1]], dim=-1) @ self._idft
        else:
            def front(frames):
                spec = torch.fft.rfft(frames * window, dim=-1)
                return self._scale_spec(torch.stack([spec.real, spec.imag], dim=-1))

            def back(out):
                out = out.float() / wnorm
                y = torch.fft.irfft(torch.complex(out[..., 0], out[..., 1]),
                                    n=cfg.win_len, dim=-1)
                return y * window
        return front, back

    def _check_stream_batch(self, batch: int) -> None:
        if self.mesh is not None and batch % self.mesh.size:
            raise ValueError(f"streaming batch ({batch}) must be a multiple of the mesh size "
                             f"({self.mesh.size}) on a sharded engine")

    def init_stream_state(self, batch: int = 1):
        """Fresh state for ``batch`` streams on the engine's device, at the
        compute dtype; under bf16 compute the DPRNN inter-GRU hiddens stay
        float32 unless ``DPDFNET_TPU_STATE_F32H=0`` (the kernels carry them
        in float32; the conv tails and delay lines join the bf16 planes).
        On a mesh of several devices: the :class:`~parallel.mesh.Sharded`
        form, ``batch / mesh.size`` streams on each device (``batch`` must
        be a multiple of the mesh size)."""
        self._check_stream_batch(batch)
        if len(self.replicas) > 1:
            n = len(self.replicas)
            return Sharded(rep._init_state(batch // n) for rep in self.replicas)
        return self._init_state(batch)

    def _init_state(self, batch: int):
        st = state_lib.init_state(self.cfg, batch=batch, dtype=self.compute_dtype,
                                  device=self.device)
        if self.compute_dtype != torch.float32 and _state_f32_hiddens():
            for key in ("dprnn_erb", "dprnn_df"):
                st[key] = [h.float() for h in st[key]]
        return st

    def _stream_step(self, kind: str):
        """The step a streaming program runs: ``fn(x, st) -> (y, st)`` over
        sample frames ``[B, T, win]`` (``"exact"``, ``"vec"``: front,
        ``forward_spec``, back) or over scaled spec frames ``[B, T, F, 2]``
        at the compute dtype (``"spec"``: ``forward_spec`` alone)."""
        def spec_fn(spec, st):
            out, st, _ = forward_spec(self.params, self.cfg, spec, st, precision=self.precision)
            return out, st

        if kind == "spec":
            return spec_fn
        front, back = self._stream_ends()

        def frames_fn(frames, st):
            out, st = spec_fn(front(frames), st)
            return back(out), st

        return frames_fn

    def _run_stream(self, kind: str, x: torch.Tensor, st, steps):
        """Run ``kind``'s step over each ``(pos, frames)`` step of ``x``
        from state ``st``; returns the output over all of x's frames and the
        new state.  Eager on a CPU engine; on a CUDA engine through the
        captured graphs, with the state copied into the batch's slot once
        and out once per call, under the engine's lock, so threads that
        share the engine never interleave their calls (the spans
        ``engine.state_in``, ``engine.replay`` with an ``engine.capture``
        per graph captured, ``engine.state_out``)."""
        if self.device.type != "cuda":
            fn = self._stream_step(kind)
            outs = []
            for pos, step in steps:
                y, st = fn(x[:, pos:pos + step], st)
                outs.append(y)
            return torch.cat(outs, dim=1), st
        B, T = x.shape[:2]
        card = self.device.index
        # the capture, the replays and the call's event on this engine's card
        with self._graph_lock, torch.cuda.device(self.device):
            with telemetry.span("engine.state_in", card=card):
                sig = tuple((tuple(leaf.shape), leaf.dtype) for _, leaf in tree_leaves(st))
                cur = torch.cuda.current_stream(self.device)
                if self._call_done is not None:       # another thread's stream may differ
                    cur.wait_event(self._call_done)
                slot = self._slots.get((B, sig))
                if slot is None:
                    slot = self._slots[(B, sig)] = _StateSlot(st)
                slot.store(st)
            with telemetry.span("engine.replay", card=card):
                y = (torch.empty_like(x) if kind == "spec" else
                     torch.empty((B, T, self.cfg.win_len), dtype=torch.float32,
                                 device=self.device))
                for pos, step in steps:
                    key = stream_graph_key(kind, B, step, self.precision, st)
                    if key not in self._graphs:
                        with telemetry.span("engine.capture", card=card):
                            self._graphs[key] = self._capture(kind, x[:, pos:pos + step], slot,
                                                              y[:, pos:pos + step])
                        continue
                    graph, gx, gy = self._graphs[key]
                    gx.copy_(x[:, pos:pos + step])
                    graph.replay()
                    self.graph_replays += 1
                    y[:, pos:pos + step].copy_(gy)
            with telemetry.span("engine.state_out", card=card):
                st = slot.dump()
                self._call_done = cur.record_event()
        return y, st

    def _capture(self, kind: str, xs: torch.Tensor, slot: _StateSlot, ys: torch.Tensor):
        """Run ``kind``'s step once eagerly on the step ``xs`` from the
        slot's state (its output goes to ``ys``, its state to the slot: the
        warm-up is this step's real work, and builds the kernel libraries,
        cuFFT plans and the cuBLAS workspace of the capture stream), then
        capture the same step on a static input into a CUDA graph that
        rewrites the slot's state in place; returns the graph, its static
        input and its static output.  The capture records launches and
        runs none, so it raises no launch counter."""
        fn = self._stream_step(kind)
        xs = xs.contiguous()                    # as the static input the graph reads
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        side, main = self._capture_stream, torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            y, new = fn(xs, slot.state)
            ys.copy_(y)
            slot.store(new)
        main.wait_stream(side)
        x_static = torch.empty_like(xs, memory_format=torch.contiguous_format)
        graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection inside the capture: collecting a dead
        # object that holds a CUDA graph destroys that graph, a call that
        # invalidates the capture in progress
        with _CAPTURE_LOCK, _gc_paused(), torch.cuda.graph(
                graph, pool=self._graph_pool, stream=side, capture_error_mode="thread_local"):
            y_static, new = fn(x_static, slot.state)
            slot.store(new)
        return graph, x_static, y_static

    def _run_shards(self, kind: str, x: torch.Tensor, st, steps):
        """:meth:`_run_stream` over the replicas: ``x`` cut into one shard
        per replica (all uploaded first), each shard through its replica.
        With one replica ``st`` is its state tree; with several it is the
        :class:`~parallel.mesh.Sharded` state (a whole-batch state tree is
        sharded first).  Returns the output shards, each on its device, and
        the new state in the form it came in."""
        self._check_stream_batch(x.shape[0])
        n = len(self.replicas)
        if n == 1:
            states = (st,)
        else:
            states = st if isinstance(st, Sharded) else shard_batch(self.mesh, st)
            if len(states) != n:
                raise ValueError(f"a state of {len(states)} shards on a mesh of {n}")
        b = x.shape[0] // n
        xs = [_upload(x[j * b:(j + 1) * b], rep.device) for j, rep in enumerate(self.replicas)]
        runs = [rep._run_stream(kind, xj, sj, steps)
                for rep, xj, sj in zip(self.replicas, xs, states)]
        return [y for y, _ in runs], (runs[0][1] if n == 1 else Sharded(s for _, s in runs))

    def _program(self, kind: str, B: int, T: int, steps):
        def run(x: torch.Tensor, st):
            if tuple(x.shape[:2]) != (B, T):
                raise ValueError(f"streaming program for B={B}, T={T} got {tuple(x.shape)}")
            with _math_mode(self.precision), torch.no_grad():
                ys, st = self._run_shards(kind, x, st, steps)
            return (ys[0] if len(ys) == 1 else
                    torch.cat([y.to(self.device) for y in ys])), st
        return run

    def _stream_fn(self, B: int, T: int):
        """Exact streaming of T frames, the JAX ``_stream_fn``:
        ``run(frames [B, T, win], st) -> (windowed frames [B, T, win], st)``
        on the engine's device, the T == 1 step once per frame, so the
        floating-point op sequence per frame is the same for every
        chunking."""
        return self._program("exact", B, T, [(t, 1) for t in range(T)])

    def _stream_vec_fn(self, B: int, T: int):
        """Throughput streaming, the JAX ``_stream_vec_fn``: ``run(frames
        [B, T, win], st)`` through one ``forward_spec`` over all T frames."""
        return self._program("vec", B, T, [(0, T)])

    def _stream_spec_fn(self, B: int, T: int):
        """The streaming step over scaled spec frames, the JAX
        ``_stream_spec_fn``: ``run(spec [B, T, F, 2], st) -> (spec_out, st)``
        (spec at the compute dtype), ``forward_spec`` once per frame, so
        chunking is bit-invariant as in :meth:`_stream_fn`."""
        return self._program("spec", B, T, [(t, 1) for t in range(T)])

    def process_frames(self, frames: np.ndarray, st, mode: str = "exact"):
        """Process ``[B, T, win_len]`` sample frames; returns windowed time
        frames ``[B, T, win_len]`` (numpy) ready for overlap-add, and the
        new state (on the device, owned by the caller).  One host-to-device
        copy of the frames and one device-to-host copy of the output per
        call.

        ``mode``:
            ``"exact"`` (default): front end, ``forward_spec`` and back end
            once per frame at T == 1 (:meth:`_stream_fn`), so the op
            sequence per frame is the same for every chunking and the
            output is bit-identical however the stream is cut.
            ``"throughput"``: one ``forward_spec`` per bucket of the
            power-of-two ladder (the JAX package's split, chunk for chunk;
            :meth:`_stream_vec_fn`); the same math, with float reduction
            orders that depend on the chunking (about 1e-5 from exact).

        On a CUDA engine each program is a captured CUDA graph (replayed
        per frame in exact mode, per bucket in throughput mode), built on
        the first call that needs it.  Threads may share an engine: a lock
        runs one call's graph work at a time.

        On a mesh ``B`` must be a multiple of the mesh size (else
        ``ValueError``); with several devices ``st`` is the
        :class:`~parallel.mesh.Sharded` state (a whole-batch tree is
        sharded first), each shard runs on its replica, and the output is
        gathered in order.

        Spans: ``engine.process_frames`` over an ``engine.upload`` per
        replica, on a card each replica's ``engine.state_in``,
        ``engine.replay`` and ``engine.state_out``, then ``engine.fetch``.
        """
        with telemetry.span("engine.process_frames"):
            frames = np.asarray(frames, dtype=np.float32)
            B, T, _ = frames.shape
            self._check_stream_batch(B)
            if mode not in ("exact", "throughput"):
                raise ValueError(f"unknown streaming mode {mode!r}")
            if T == 0:
                return np.zeros((B, 0, self.cfg.win_len), np.float32), st
            if mode == "exact":
                kind, steps = "exact", [(t, 1) for t in range(T)]
            else:
                kind, steps, pos = "vec", [], 0
                while pos < T:
                    step = max(b for b in _STREAM_T_BUCKETS if b <= T - pos)
                    steps.append((pos, step))
                    pos += step
            with _math_mode(self.precision), torch.no_grad():
                ys, st = self._run_shards(kind, torch.from_numpy(np.ascontiguousarray(frames)),
                                          st, steps)
            return _host(ys), st

    def enhance_waveforms(self, wavs: np.ndarray, attn_limit_db: Optional[float] = None,
                          lengths: Optional[np.ndarray] = None,
                          progress_callback=None) -> np.ndarray:
        """Enhance a batch of waveforms at the model sample rate.

        Args:
            wavs: ``[S]`` or ``[B, S]`` float32 at ``cfg.sample_rate``.
            attn_limit_db: optional attenuation limit (dB).
            lengths: optional per-utterance valid lengths (defaults to S);
                output past each length is zeroed, and each row runs only
                the segments its own length needs.
            progress_callback: optional ``fn(done, total)`` in frames,
                called with ints before the first segment and after each
                one (the segment-stepped path; the same output).

        Returns:
            Enhanced float32 audio (numpy) with the same shape as ``wavs``.

        The batch is zero-padded to ``bucket_len(S)`` samples, whole
        segments of frames.  A row's need is the segments of
        ``bucket_len(length)``, none for an empty row or a mesh's padding
        row; each shard's rows run longest need first, and segment ``i``
        runs over the rows whose need reaches it (:meth:`_offline_shards`).

        Spans: ``engine.enhance_waveforms`` over ``engine.pad`` (bucket,
        zero-pad, the schedule, an ``engine.upload`` per replica and per
        row order), ``engine.launch`` (every replica's work enqueued),
        ``engine.fetch``, ``engine.unpad``.  Counters:
        ``engine.row_segments`` (row-segments run) and
        ``engine.row_segments_full`` (rows times segments of the call).
        """
        with telemetry.span("engine.enhance_waveforms"):
            value = audio_lib.validate_attn_limit_db(attn_limit_db)
            alpha = 0.0 if value is None else float(np.float32(10.0 ** (-value / 20.0)))
            with telemetry.span("engine.pad"):
                squeeze = np.ndim(wavs) == 1
                x = np.atleast_2d(np.asarray(wavs, dtype=np.float32))
                B, S = x.shape
                S_pad = self.bucket_len(S)
                n_seg = int(self._bucket_segments(S))
                n = len(self.replicas)
                # on a mesh the batch is padded with zero rows to a multiple of its size
                xp = np.zeros((-(-B // n) * n, S_pad), np.float32)
                xp[:B, :S] = x
                b = xp.shape[0] // n
                need = np.zeros(xp.shape[0], np.int64)
                if lengths is None:
                    need[:B] = n_seg
                else:
                    ln = np.clip(np.asarray(lengths, np.int64).reshape(-1), 0, S)
                    need[:B] = np.where(ln > 0, self._bucket_segments(ln), 0)
                telemetry.count("engine.row_segments", int(need.sum()))
                telemetry.count("engine.row_segments_full", B * n_seg)
                wavs, plans = [], []
                for j, rep in enumerate(self.replicas):
                    nj = need[j * b:(j + 1) * b]
                    order = np.argsort(-nj, kind="stable")
                    wavs.append(_upload(torch.from_numpy(xp[j * b:(j + 1) * b]), rep.device))
                    plans.append((None if (order == np.arange(b)).all() else
                                  _upload(torch.from_numpy(order), rep.device),
                                  [int(np.count_nonzero(nj > i)) for i in range(n_seg)]))
            with telemetry.span("engine.launch"), _math_mode(self.precision):
                ys = self._offline_shards(wavs, alpha, progress_callback, plans)
            y = _host(ys)

            with telemetry.span("engine.unpad"):
                out = np.zeros_like(x)
                n = min(S, y.shape[1])
                out[:, :n] = y[:B, :n]
                if lengths is not None:
                    for i, ln in enumerate(np.asarray(lengths).reshape(-1)):
                        out[i, int(ln):] = 0.0
            return out[0] if squeeze else out
