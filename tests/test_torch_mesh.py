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

from torch_testing import jax_params_np

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
