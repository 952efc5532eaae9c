"""The port's multi-device path against the JAX package's mesh.

The port's ``Engine(mesh=make_mesh(["cpu"] * 8))`` (eight replicas of one
CPU device: torch has one CPU device) against the JAX ``Engine(mesh=
pmesh.make_mesh(jax.devices()[:8]))`` (the eight virtual CPU devices of
``tests/conftest.py``) on ``dpdfnet2`` with the same random contracted
weights; then the port's mesh against the port without one, the
batch-sharded train step against the step without a mesh and against the
JAX step with ``optax.sgd`` (so the update is the gradient), and the
kernel wrappers' device guard with the launch stubbed out.

Tolerances: offline and streaming within 1e-4 of the JAX mesh (the
engine's bound against the JAX engine); ``turbo`` within max-abs 2e-6 and
rel_rms 3e-3 (the tier bound of ``test_torch_tiers.py``); the port's mesh
within 1e-6 of the port without a mesh (measured on the CPU: 2.9e-11
offline, 4.5e-13 in exact and throughput mode, where a shard of one row
takes another GEMM order than the whole batch); exact streaming on the
mesh bit-identical across chunkings; the train step's loss within 1e-5
relative and each leaf's update within 1e-4 of its largest magnitude.
"""

import functools
import gc
import sys
import threading
import time
import types
import weakref

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from dpdfnet_tpu import train as jax_train
from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models.state import init_state as jax_init_state
from dpdfnet_tpu.parallel import mesh as jax_pmesh
from dpdfnet_tpu.runtime import engine as jax_engine

from dpdfnet_tpu_torch import train
from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models.state import init_state
from dpdfnet_tpu_torch.ops import gru_kernels as gk
from dpdfnet_tpu_torch.parallel import mesh as pmesh
from dpdfnet_tpu_torch.quality import speechlike_test_signal
from dpdfnet_tpu_torch.runtime import engine as engine_mod
from dpdfnet_tpu_torch.runtime.engine import Engine, engine_from_quality
from dpdfnet_tpu_torch.utils.serialization import params_from_jax
from dpdfnet_tpu_torch.utils.tree import tree_leaves

from torch_testing import jax_params_np, port_params_np

MODEL = "dpdfnet2"
N_DEV = 8
ATOL = 1e-4
SELF_ATOL = 1e-6
TURBO_ATOL = 2e-6
TURBO_REL_RMS = 3e-3
LOSS_REL = 1e-5
UPDATE_REL = 1e-4
S_OFF_HOPS = 24          # offline cases: S = 24 hops, one segment
T_STREAM = 4             # streaming cases: frames per stream


@functools.lru_cache(maxsize=None)
def _meshes():
    return jax_pmesh.make_mesh(jax.devices()[:N_DEV]), pmesh.make_mesh(["cpu"] * N_DEV)


@functools.lru_cache(maxsize=None)
def _engines(quality):
    """(JAX mesh engine, port mesh engine, port engine without a mesh), one
    set per tier shared by the offline and streaming cases; the offline
    bucket is the cases' ``S_OFF`` samples."""
    jm, tm = _meshes()
    cfg, p = get_config(MODEL), jax_params_np(MODEL)
    bucket_s = S_OFF_HOPS * cfg.hop / cfg.sample_rate
    return (jax_engine.engine_from_quality(jax_get_config(MODEL), p, quality, mesh=jm,
                                           bucket_s=bucket_s),
            engine_from_quality(cfg, params_from_jax(p, device="cpu"), quality, mesh=tm,
                                bucket_s=bucket_s),
            engine_from_quality(cfg, params_from_jax(p, device="cpu"), quality, device="cpu",
                                bucket_s=bucket_s))


def _rel_rms(got, ref):
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def _frames(B, T, seed):
    cfg = get_config(MODEL)
    wav = speechlike_test_signal((T + 1) * cfg.hop / cfg.sample_rate, cfg.sample_rate,
                                 seed=seed, batch=B)
    return wav[:, np.arange(T)[:, None] * cfg.hop + np.arange(cfg.win_len)[None, :]]


# --------------------------------------------------------------------------- #
# Mesh
# --------------------------------------------------------------------------- #

def test_make_mesh_and_placements():
    m = pmesh.make_mesh(["cpu", "cpu", "cpu"])
    assert m.size == 3 and pmesh.BATCH_AXIS == "data"
    assert all(d == torch.device("cpu") for d in m.devices)
    with pytest.raises(ValueError, match="at least one device"):
        pmesh.make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.make_mesh()
    tree = {"a": torch.arange(6.0).reshape(6, 1), "b": [np.arange(12.0).reshape(6, 2)]}
    parts = pmesh.shard_batch(m, tree)
    assert isinstance(parts, pmesh.Sharded) and len(parts) == 3
    assert torch.equal(parts[1]["a"], torch.tensor([[2.0], [3.0]]))
    np.testing.assert_array_equal(
        np.concatenate([p["b"][0].numpy() for p in parts]), tree["b"][0])
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        pmesh.shard_batch(m, {"a": torch.zeros(4, 1)})
    one = pmesh.shard_batch(pmesh.make_mesh(["cpu"]), tree)
    assert isinstance(one, dict) and torch.equal(one["a"], tree["a"])
    assert pmesh.gather(pmesh.Sharded([torch.ones(2), torch.zeros(1)])).tolist() == [1, 1, 0]


def test_mesh_offline_pads_and_matches_jax_and_single_device():
    """B=6 on a mesh of 8 (padded to 8 with zero rows): the port's mesh
    within 1e-4 of the JAX mesh and within 1e-6 of the port without a
    mesh; the stepped path (``progress_callback``) gives the same output
    with one report per segment over all shards."""
    cfg = get_config(MODEL)
    S = cfg.hop * S_OFF_HOPS
    j, t, one = _engines("high")
    wav = speechlike_test_signal(S / cfg.sample_rate, cfg.sample_rate, seed=1, batch=6)
    lengths = np.array([S] * 5 + [S - cfg.hop * 7])
    ref = j.enhance_waveforms(wav, lengths=lengths)
    got = t.enhance_waveforms(wav, lengths=lengths)
    assert got.shape == (6, S) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, one.enhance_waveforms(wav, lengths=lengths), atol=SELF_ATOL)
    calls = []
    stepped = t.enhance_waveforms(wav, lengths=lengths,
                                  progress_callback=lambda d, n: calls.append((d, n)))
    np.testing.assert_array_equal(stepped, got)
    T = calls[0][1]
    assert calls[0] == (0, T) and calls[-1] == (T, T)
    assert len(calls) == 1 + -(-T // t.seg_frames)
    assert len(t.replicas) == N_DEV and t.replicas[0] is t and one.replicas == (one,)


def test_mesh_replica_whose_rows_all_end_early_launches_nothing_after(monkeypatch):
    """A two-replica mesh at ``seg_frames=16``, B=3 padded to 4: the first
    shard's rows run 4 and 3 segments, the second shard's only row ends in
    the first segment and its padding row runs none, so the second replica
    runs one segment of one row and nothing after.  Within 1e-6 of the
    engine without a mesh; the stepped path reports every segment, each
    after that segment of both replicas (the replicas run in threads of
    their own, so only each replica's own order and the barrier between
    segments are fixed)."""
    cfg = get_config(MODEL)
    p = params_from_jax(jax_params_np(MODEL), device="cpu")
    kw = dict(seg_frames=16, bucket_s=0.0)
    two = Engine(cfg, p, mesh=pmesh.make_mesh(["cpu"] * 2), **kw)
    one = Engine(cfg, p, device="cpu", **kw)
    lengths = np.array([7000, 6000, 900])
    wav = speechlike_test_signal(7000 / cfg.sample_rate, cfg.sample_rate, seed=9, batch=3)
    wav[np.arange(7000)[None, :] >= lengths[:, None]] = 0.0
    ref = one.enhance_waveforms(wav, lengths=lengths)
    rows = []
    orig = Engine._segment

    def seg(self, spec_seg, st):
        rows.append((self is two, spec_seg.shape[0]))
        return orig(self, spec_seg, st)
    monkeypatch.setattr(Engine, "_segment", seg)
    calls = []
    got = two.enhance_waveforms(wav, lengths=lengths,
                                progress_callback=lambda d, n: calls.append((d, n)))
    assert [n for first, n in rows if first] == [2, 2, 2, 1]
    assert [n for first, n in rows if not first] == [1]
    assert (False, 1) in rows[:2]               # before either replica's second segment
    assert calls == [(0, 64), (16, 64), (32, 64), (48, 64), (64, 64)]
    assert float(np.abs(got[2, :900]).max()) > 0 and np.all(got[2, 900:] == 0.0)
    np.testing.assert_allclose(got, ref, atol=SELF_ATOL)


def test_mesh_of_one_device_is_the_engine_without_a_mesh():
    cfg = get_config(MODEL)
    p = params_from_jax(jax_params_np(MODEL), device="cpu")
    e1 = Engine(cfg, p, device="cpu")
    em = Engine(cfg, p, mesh=pmesh.make_mesh(["cpu"]))
    wav = speechlike_test_signal(0.1, cfg.sample_rate, seed=2, batch=3)
    assert np.array_equal(em.enhance_waveforms(wav), e1.enhance_waveforms(wav))
    fr = _frames(3, 2, seed=3)
    y1, s1 = e1.process_frames(fr, e1.init_stream_state(3))
    ym, sm = em.process_frames(fr, em.init_stream_state(3))
    assert np.array_equal(ym, y1) and isinstance(sm, dict)
    with pytest.raises(ValueError, match="first device"):
        Engine(cfg, p, device="meta", mesh=pmesh.make_mesh(["cpu"]))


def test_engine_is_freed_when_dropped_without_the_cyclic_collector():
    """An engine, with or without a mesh, holds no reference to itself, so
    dropping it frees it (and its CUDA graphs) at once; the cyclic
    collector, which could free a dead engine's graphs in the middle of
    another engine's capture and so invalidate that capture, is off
    inside a capture."""
    cfg = get_config(MODEL)
    p = params_from_jax(jax_params_np(MODEL), device="cpu")
    was = gc.isenabled()
    gc.disable()
    try:
        for mesh in (None, pmesh.make_mesh(["cpu"] * 2)):
            e = Engine(cfg, p, device="cpu", mesh=mesh)
            refs = [weakref.ref(r) for r in e.replicas]
            del e
            assert all(r() is None for r in refs), mesh
    finally:
        if was:
            gc.enable()
    with engine_mod._gc_paused():
        assert not gc.isenabled()
    assert gc.isenabled() == was


# --------------------------------------------------------------------------- #
# The offline call's replica threads
# --------------------------------------------------------------------------- #

OFFLINE_CASES = {
    # B, the rows' lengths in 16-frame segments (None: no lengths), S
    "no_lengths": (4, None, 2.5),
    "lengths": (4, (3.2, 1.0, 1.9, 0.0), 3.2),
    "rows_end_early": (3, (4.0, 3.0, 0.5), 4.0),
}


@functools.lru_cache(maxsize=None)
def _two_and_one(model):
    """A mesh of two CPU replicas and one engine without a mesh, on the same
    weights, at ``seg_frames=16`` and no bucket floor."""
    cfg, p = get_config(model), port_params_np(model)
    kw = dict(seg_frames=16, bucket_s=0.0)
    return (Engine(cfg, p, mesh=pmesh.make_mesh(["cpu"] * 2), **kw),
            Engine(cfg, p, device="cpu", **kw))


def _offline_case(model, case):
    cfg = get_config(model)
    B, segs, S = OFFLINE_CASES[case]
    seg = 16 * cfg.hop
    S = int(S * seg)
    wav = speechlike_test_signal(S / cfg.sample_rate, cfg.sample_rate, seed=11, batch=B)
    wav = np.ascontiguousarray(wav[:, :S])
    lengths = None if segs is None else np.array([int(k * seg) for k in segs])
    if lengths is not None:
        wav[np.arange(S)[None, :] >= lengths[:, None]] = 0.0
    return wav, lengths


@pytest.mark.parametrize("case", sorted(OFFLINE_CASES))
@pytest.mark.parametrize("model", ["dpdfnet2", "dpdfnet8_48khz_hr"])
def test_mesh_offline_bit_identical_to_one_engine_per_shard(model, case):
    """Each replica's rows, run in its own thread, equal bit for bit the
    engine without a mesh on that replica's shard (its rows, and the
    mesh's zero padding rows of length 0); the stepped path gives the
    same output and the reports of the engine without a mesh."""
    two, one = _two_and_one(model)
    wav, lengths = _offline_case(model, case)
    B, S = wav.shape
    got = two.enhance_waveforms(wav, lengths=lengths)
    assert got.shape == (B, S) and float(np.abs(got).max()) > 0
    b = -(-B // 2)
    for j in range(2):
        rows = slice(j * b, min((j + 1) * b, B))
        r = rows.stop - rows.start
        shard = np.zeros((b, S), np.float32)
        shard[:r] = wav[rows]
        ln = None
        if lengths is not None or r < b:
            ln = np.zeros(b, np.int64)
            ln[:r] = S if lengths is None else lengths[rows]
        np.testing.assert_array_equal(got[rows], one.enhance_waveforms(shard, lengths=ln)[:r])
    calls, ref_calls = [], []
    stepped = two.enhance_waveforms(wav, lengths=lengths,
                                    progress_callback=lambda d, n: calls.append((d, n)))
    one.enhance_waveforms(wav, lengths=lengths,
                          progress_callback=lambda d, n: ref_calls.append((d, n)))
    np.testing.assert_array_equal(stepped, got)
    assert calls == ref_calls and len(calls) == 1 + -(-calls[0][1] // 16)
    assert all(type(d) is int and type(n) is int for d, n in calls)


class Boom(RuntimeError):
    pass


def _on_time(fn, seconds=120):
    """``fn()`` in a thread of its own, joined within ``seconds``: its
    exception (or None), and whether it ended."""
    got = []

    def run():
        try:
            fn()
            got.append(None)
        except BaseException as exc:            # noqa: BLE001 (handed to the test)
            got.append(exc)
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=seconds)
    return (got[0] if got else None), not th.is_alive()


def test_mesh_progress_callback_runs_in_the_calling_thread():
    """The replicas' threads queue the reports and the calling thread makes
    them, so a callback that calls the same engine again (which queues
    work behind the replicas' current call) returns, and the outer call
    gives the same output and reports as without it."""
    two, _ = _two_and_one(MODEL)
    wav, lengths = _offline_case(MODEL, "lengths")
    want = two.enhance_waveforms(wav, lengths=lengths)
    inner = two.enhance_waveforms(wav[:1])
    callers, seen, nested, got = [], [], [], []

    def report(done, total):
        seen.append(((done, total), threading.current_thread()))
        if done and not nested:
            nested.append(two.enhance_waveforms(wav[:1]))

    def call():
        callers.append(threading.current_thread())
        got.append(two.enhance_waveforms(wav, lengths=lengths, progress_callback=report))

    err, ended = _on_time(call)
    assert ended, "a callback that called the engine again never returned"
    assert err is None
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(nested[0], inner)
    ref = []
    two.enhance_waveforms(wav, lengths=lengths, progress_callback=lambda d, n: ref.append((d, n)))
    assert [r for r, _ in seen] == ref and len(ref) > 2
    assert all(t is callers[0] for _, t in seen)


@pytest.mark.parametrize("where", ["segment", "segment_stepped", "callback"])
def test_mesh_replica_exception_reaches_the_caller(monkeypatch, where):
    """An exception raised in the second replica's thread (in a segment,
    with or without the progress barrier) or in the progress callback
    reaches the caller as the same object, after both replicas stopped,
    and never leaves the other replica waiting; the engine then runs the
    next call as before."""
    two, _ = _two_and_one(MODEL)
    wav, lengths = _offline_case(MODEL, "lengths")
    want = two.enhance_waveforms(wav, lengths=lengths)
    raised = []
    orig = Engine._segment

    def seg(self, spec_seg, st):
        if self is not two and where != "callback":
            raised.append(Boom(where))
            raise raised[-1]
        return orig(self, spec_seg, st)

    def report(done, total):
        if where == "callback" and done > 0:
            raised.append(Boom(where))
            raise raised[-1]

    monkeypatch.setattr(Engine, "_segment", seg)
    progress = None if where == "segment" else report
    err, ended = _on_time(lambda: two.enhance_waveforms(wav, lengths=lengths,
                                                        progress_callback=progress))
    assert ended, "a replica thread never stopped"
    assert len(raised) == 1 and err is raised[0]
    del err
    raised.clear()
    monkeypatch.setattr(Engine, "_segment", orig)
    np.testing.assert_array_equal(two.enhance_waveforms(wav, lengths=lengths), want)


@pytest.mark.parametrize("calls", ["none", "one", "one_failed"])
def test_mesh_replica_threads_end_when_the_engine_is_freed(monkeypatch, calls):
    """A mesh engine starts its replica threads at its first offline call,
    one per replica, and they end when the engine is freed (by its last
    reference, the cyclic collector off), after a call that failed too."""
    cfg = get_config(MODEL)
    before = set(threading.enumerate())
    wav, _ = _offline_case(MODEL, "no_lengths")
    was = gc.isenabled()
    gc.disable()
    try:
        eng = Engine(cfg, port_params_np(MODEL), mesh=pmesh.make_mesh(["cpu"] * 3),
                     seg_frames=16, bucket_s=0.0)
        if calls == "one_failed":
            def seg(self, spec_seg, st):
                raise Boom("segment")
            monkeypatch.setattr(Engine, "_segment", seg)
            with pytest.raises(Boom):
                eng.enhance_waveforms(wav)
        elif calls == "one":
            eng.enhance_waveforms(wav)
        started = [t for t in threading.enumerate() if t not in before]
        assert len(started) == (0 if calls == "none" else 3)
        ref = weakref.ref(eng)
        del eng
        deadline = time.monotonic() + 10    # a thread may drop the last reference
        while ref() is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ref() is None
    finally:
        if was:
            gc.enable()
    for t in started:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in started)
    assert not set(started) & set(threading.enumerate())


def test_turns_go_one_at_a_time_in_the_order_asked():
    """The replica threads' turns at enqueueing (``engine._Turns``): one
    holder at a time, granted in the order they were asked for, and
    handed on when a holder raises."""
    turns = engine_mod._Turns()
    order, inside, most = [], [0], [0]

    def take(k):
        try:
            with turns:
                inside[0] += 1
                most[0] = max(most[0], inside[0])
                order.append(k)
                time.sleep(0.002)
                inside[0] -= 1
                if k == 2:
                    raise Boom("turn")
        except Boom:
            pass

    threads = []
    with turns:                                 # every request waits behind this one
        for k in range(6):
            threads.append(threading.Thread(target=take, args=(k,)))
            threads[-1].start()
            deadline = time.monotonic() + 10
            while turns._next < k + 2 and time.monotonic() < deadline:
                time.sleep(0.001)
            assert turns._next == k + 2
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert order == list(range(6)) and most[0] == 1


def test_launch_counter_loses_no_increment_across_threads(monkeypatch):
    """The kernel wrappers' launch counters, which a mesh's replica threads
    raise at once: 16 threads x 2000 increments, switching threads every
    microsecond, count every one."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    wrapper = gk.dprnn_intra_block
    before = wrapper.launches
    barrier = threading.Barrier(16, timeout=30)

    def work():
        barrier.wait()
        for _ in range(2000):
            gk._count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert wrapper.launches == before + 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        wrapper.launches = before


def test_mesh_exact_streaming_is_chunk_invariant_and_matches_jax():
    """8 streams x 4 frames, in one call and as 1 + 3 from the carried
    state: bit-identical on the mesh, within 1e-4 of the JAX mesh, within
    1e-6 of the port without a mesh; throughput mode too."""
    j, t, one = _engines("high")
    fr = _frames(N_DEV, T_STREAM, seed=4)
    ref, _ = j.process_frames(fr, j.init_stream_state(batch=N_DEV))
    st = t.init_stream_state(batch=N_DEV)
    assert isinstance(st, pmesh.Sharded) and len(st) == N_DEV
    whole, st_whole = t.process_frames(fr, st)
    assert float(np.abs(whole).max()) > 0
    y1, st1 = t.process_frames(fr[:, :1], t.init_stream_state(batch=N_DEV))
    y2, st2 = t.process_frames(fr[:, 1:], st1)
    assert np.array_equal(np.concatenate([y1, y2], axis=1), whole)
    for a, b in zip(tree_leaves(st_whole), tree_leaves(st2)):
        assert torch.equal(a[1], b[1])
    np.testing.assert_allclose(whole, ref, atol=ATOL)
    y_one, _ = one.process_frames(fr, one.init_stream_state(batch=N_DEV))
    np.testing.assert_allclose(whole, y_one, atol=SELF_ATOL)
    tp, _ = t.process_frames(fr, t.init_stream_state(batch=N_DEV), mode="throughput")
    tp_one, _ = one.process_frames(fr, one.init_stream_state(batch=N_DEV), mode="throughput")
    np.testing.assert_allclose(tp, tp_one, atol=SELF_ATOL)
    # a whole-batch state tree is sharded on the way in
    y_tree, _ = t.process_frames(fr, one.init_stream_state(batch=N_DEV))
    assert np.array_equal(y_tree, whole)


def test_mesh_turbo_matches_jax_turbo():
    cfg = get_config(MODEL)
    S = cfg.hop * S_OFF_HOPS
    j, t, _ = _engines("turbo")
    wav = speechlike_test_signal(S / cfg.sample_rate, cfg.sample_rate, seed=5, batch=N_DEV)
    ref, got = j.enhance_waveforms(wav), t.enhance_waveforms(wav)
    assert float(np.abs(got - ref).max()) <= TURBO_ATOL and _rel_rms(got, ref) <= TURBO_REL_RMS
    fr = _frames(N_DEV, T_STREAM, seed=6)
    yj, _ = j.process_frames(fr, j.init_stream_state(batch=N_DEV))
    yt, st = t.process_frames(fr, t.init_stream_state(batch=N_DEV))
    assert float(np.abs(yt).max()) > 0
    assert float(np.abs(yt - yj).max()) <= TURBO_ATOL and _rel_rms(yt, yj) <= TURBO_REL_RMS
    assert st[0]["dprnn_erb"][0].dtype == torch.float32
    assert st[0]["erb_conv0_tail"].dtype == torch.bfloat16


def test_mesh_rejects_a_stream_batch_it_cannot_split():
    _, t, _ = _engines("high")
    with pytest.raises(ValueError, match="multiple of the mesh"):
        t.init_stream_state(batch=3)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        t.process_frames(_frames(3, 1, seed=7), None)


def test_sharded_enhance_and_stream_step_match_jax():
    """``make_sharded_enhance`` on a batch given in its sharded form, and
    ``make_sharded_stream_step`` over two calls with the carried state
    (outputs within 1e-4 of the JAX functions'); the engines are cached
    by the params object."""
    cfg = get_config(MODEL)
    jm, tm = _meshes()
    p_np = jax_params_np(MODEL)
    p = params_from_jax(p_np, device="cpu")
    S = cfg.hop * 8
    wav = speechlike_test_signal(S / cfg.sample_rate, cfg.sample_rate, seed=8, batch=N_DEV)
    jfn = jax_pmesh.make_sharded_enhance(jax_get_config(MODEL), jm, bucket_s=S / cfg.sample_rate)
    tfn = pmesh.make_sharded_enhance(cfg, tm, bucket_s=S / cfg.sample_rate)
    ref = np.asarray(jfn(p_np, jnp.asarray(wav)))
    got = tfn(p, pmesh.shard_batch(tm, torch.from_numpy(wav)))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(tfn(p, wav), got)

    jstep = jax_pmesh.make_sharded_stream_step(jax_get_config(MODEL), jm)
    tstep = pmesh.make_sharded_stream_step(cfg, tm)
    rng = np.random.default_rng(1)
    spec = (0.1 * rng.normal(size=(N_DEV, 3, cfg.freq_bins, 2))).astype(np.float32)
    jst = jax_pmesh.shard_batch(jm, jax_init_state(jax_get_config(MODEL), batch=N_DEV))
    tst = pmesh.shard_batch(tm, init_state(cfg, batch=N_DEV, device="cpu"))
    outs = []
    for _ in range(2):
        jo, jst = jstep(p_np, jnp.asarray(spec), jst)
        to, tst = tstep(p, torch.from_numpy(spec), tst)
        assert isinstance(tst, pmesh.Sharded) and to.shape == spec.shape
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
        outs.append(to)
    assert float((outs[1] - outs[0]).abs().max()) > 0          # the state evolved


# --------------------------------------------------------------------------- #
# The batch-sharded train step
# --------------------------------------------------------------------------- #

def _updates(before, after):
    return {k: after[k].detach().numpy() - before[k] for k in before}


def test_mesh_train_step_matches_the_step_without_a_mesh_and_jax():
    """The update of one SGD step, ``new - old``: with a learning rate of
    2^20 it is the gradient scaled exactly, far above the rounding of the
    weights it is taken from (float32 weights near 0.1 round at 1e-8,
    which at a learning rate of 1 is above 1e-4 of a small leaf's
    gradient)."""
    cfg = get_config(MODEL)
    B, lr = 4, 2.0 ** 20
    rng = np.random.default_rng(0)
    n = int(0.12 * cfg.sample_rate)
    clean = (0.2 * np.sin(2 * np.pi * 300 * np.arange(n) / cfg.sample_rate)
             * (1 + np.arange(B))[:, None] / B).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    p_np = jax_params_np(MODEL)

    jm = jax_pmesh.make_mesh(jax.devices()[:B])
    opt = optax.sgd(lr)
    jstep = jax_train.make_train_step(jax_get_config(MODEL), opt, mesh=jm)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    new, _, jloss, _ = jstep(jp, opt.init(jp), noisy, clean)
    before = dict(tree_leaves(p_np))
    jup = {k: np.asarray(v) - before[k] for k, v in tree_leaves(new)}

    results = {}
    for name, mesh in (("mesh", pmesh.make_mesh(["cpu"] * B)), ("none", None)):
        p = params_from_jax(p_np, device="cpu")
        before = {k: v.detach().numpy().copy() for k, v in tree_leaves(p)}
        step = train.make_train_step(
            cfg, torch.optim.SGD(train.trainable_parameters(p), lr=lr), mesh=mesh)
        loss, aux = step(p, torch.from_numpy(noisy), torch.from_numpy(clean))
        assert set(aux) == {"spec", "lsnr"} and not loss.requires_grad
        results[name] = (float(loss), _updates(before, dict(tree_leaves(p))))

    for name, ref_loss, ref_up in (("none", *results["none"]), ("jax", float(jloss), jup)):
        loss, up = results["mesh"]
        assert abs(loss - ref_loss) <= LOSS_REL * abs(ref_loss), (name, loss, ref_loss)
        for k, r in ref_up.items():
            scale = max(float(np.abs(r).max()), 1e-12)
            err = float(np.abs(up[k] - r).max())
            assert err <= UPDATE_REL * scale, (name, k, err, scale)
    assert not np.any(results["mesh"][1]["erb_fb"])


# --------------------------------------------------------------------------- #
# The device guard of the kernel launches
# --------------------------------------------------------------------------- #

class _Guard:
    """Stand-ins for ``torch.cuda.device`` / ``current_stream``: record the
    device each launch ran under and hand each device its own stream."""

    def __init__(self):
        self.current = None
        self.calls = []

    def device(self, dev):
        guard = self

        class _Ctx:
            def __enter__(self):
                self.prev, guard.current = guard.current, dev

            def __exit__(self, *exc):
                guard.current = self.prev

        return _Ctx()

    def current_stream(self, dev=None):
        return type("S", (), {"cuda_stream": 1000 + hash(str(dev)) % 1000})()

    def fn(self, lib, name):
        def call(*args):
            self.calls.append((name, self.current, args[-1]))
            return 0
        return call


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def _guard_cases():
    C = 64
    w6, b2 = _meta(2 * C, 6 * C), _meta(2, 6 * C)
    vec = _meta(1, C)
    stack = [_meta(*s) for s in gk._stack_shapes(2, C).values()]
    return {
        "dprnn_intra_block": lambda: gk._intra_cuda(_meta(8, 48, C), w6, w6, b2,
                                                    _meta(2 * C, C), vec, vec, vec, 0),
        "dprnn_inter_block": lambda: gk._inter_cuda(
            _meta(2, 4, 48, C), _meta(2, 48, C), _meta(C, 3 * C), _meta(3 * C),
            _meta(C, 3 * C), _meta(3 * C), _meta(C, C), vec, vec, vec, 0, False, False),
        "relayout_fm": lambda: gk._relayout_cuda(_meta(2, 4, 48, C), torch.float32),
        "gru_bidir": lambda: gk._bidir_cuda(_meta(8, 48, C), w6, w6, b2),
        "dprnn_stack": lambda: gk._stack_cuda(_meta(2, 1, 48, C), _meta(2, 2, 48, C), stack),
        "gru_scan": lambda: gk._scan_cuda(_meta(2, 3, 256), _meta(2, 256), _meta(256, 768),
                                          _meta(768), _meta(256, 768), _meta(768), False),
        "dprnn_intra_block_v2": lambda: gk._intra_v2_cuda(
            _meta(8, 48, C), _meta(C, 6 * C), _meta(2 * C, 8 * C), b2, vec, vec, vec, True),
        "dprnn_inter_block_v2": lambda: gk._inter_v2_cuda(
            _meta(2, 4, 48, 3 * C), _meta(2, 4, 48, C), _meta(2, 48, C), _meta(C, 4 * C),
            _meta(3 * C), vec, vec, vec),
    }


def _stub_launches(monkeypatch, guard):
    def require(what, planes, weights):
        devs = {t.device for t in (*planes.values(), *weights.values())}
        assert len(devs) == 1, what
        return devs.pop()

    monkeypatch.setattr(gk, "_require_cuda", require)
    monkeypatch.setattr(gk, "_fn", guard.fn)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_gru_scan_max_clusters", lambda H, index: 16)
    monkeypatch.setattr(torch.cuda, "device", guard.device)
    monkeypatch.setattr(torch.cuda, "current_stream", guard.current_stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


@pytest.mark.parametrize("name", sorted(_guard_cases()))
def test_kernel_launch_runs_under_its_tensors_device(monkeypatch, name):
    """Each CUDA op enters the device guard of the device its tensors lie
    on (``_require_cuda``'s) and passes that device's current stream, and
    counts the launch inside it.  The tensors are meta tensors and the C
    entry a stub, so this runs on the CPU."""
    guard = _Guard()
    _stub_launches(monkeypatch, guard)
    wrapper = getattr(gk, name)
    before = wrapper.launches
    try:
        _guard_cases()[name]()
        meta = torch.device("meta")
        assert [(c[1], c[2]) for c in guard.calls] == [
            (meta, guard.current_stream(meta).cuda_stream)]
        assert guard.current is None and wrapper.launches == before + 1
    finally:
        wrapper.launches = before


@pytest.mark.parametrize("tool", ["intra", "inter"])
def test_ablation_tool_launch_runs_under_its_tensors_device(monkeypatch, tool):
    from dpdfnet_tpu_torch.tools import inter_step_ablation, intra_step_ablation

    guard = _Guard()
    _stub_launches(monkeypatch, guard)
    C = 64
    vec = _meta(1, C)
    if tool == "intra":
        mod, run = intra_step_ablation, intra_step_ablation.run_intra
        monkeypatch.setattr(mod._build, "load", lambda n: types.SimpleNamespace(
            intra_ablation_launch=guard.fn(n, "intra_ablation_launch")))
        call = lambda: run("full", _meta(8, 48, C), _meta(2 * C, 6 * C), _meta(2 * C, 6 * C),
                           _meta(2, 6 * C), _meta(2 * C, C), vec, vec, vec)
    else:
        mod, run = inter_step_ablation, inter_step_ablation.run_inter
        monkeypatch.setattr(mod._build, "load", lambda n: types.SimpleNamespace(
            inter_ablation_launch=guard.fn(n, "inter_ablation_launch")))
        call = lambda: run("full", _meta(4, 8, C), _meta(8, C), _meta(C, 3 * C), _meta(3 * C),
                           _meta(C, 3 * C), _meta(3 * C), _meta(C, C), vec, vec, vec)
    before = run.launches
    try:
        call()
        meta = torch.device("meta")
        assert [(c[1], c[2]) for c in guard.calls] == [
            (meta, guard.current_stream(meta).cuda_stream)]
        assert run.launches == before + 1
    finally:
        run.launches = before
