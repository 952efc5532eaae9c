"""The port's spans and counters (``runtime/telemetry.py``) on the CPU.

Off, a span is a flag test and nothing more; under a ``torch.profiler`` or
``telemetry.recording()`` the pool's and the engine's calls record their
phases with parents, one call id per root, and self times that add up to
the root's duration; threads keep their own stacks; the store is capped.
The benchmark's readers of the spans (``benchmark/metrics/``, loaded by
path) read a number from a traced run and nothing before one.  The graph
spans (state in, capture, replay, state out) run only on a card:
``tests/test_torch_cuda.py``.  ``runtime/profile.py``'s reading of a
trace is checked on synthetic events.
"""

import importlib.util
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models.params import contract_params, init_params
from dpdfnet_tpu_torch.runtime import profile as profile_lib
from dpdfnet_tpu_torch.runtime import telemetry
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.serving import MultiStreamEnhancer

import torch_testing  # noqa: F401  (the thread budget)

ROOT = Path(__file__).resolve().parents[1]
# each reader of the benchmark, with the calls whose spans it reads
READERS = {"pool.loops_ms": "live", "engine.state_ms": "live", "engine.replay_ms": "live",
           "engine.fetch_ms": "both", "engine.pad_ms": "offline", "engine.launch_ms": "offline"}

# what a CPU engine's calls record: the pool over the engine's live call
# (the state's gather and scatter for a bucket of part of the pool), and
# the offline call; name -> parent's name
POOL_TREE = {"pool.process_many": None, "pool.stage": "pool.process_many",
             "pool.frame": "pool.process_many", "pool.state": "pool.process_many",
             "engine.process_frames": "pool.process_many",
             "engine.upload": "engine.process_frames", "engine.fetch": "engine.process_frames",
             "pool.overlap_add": "pool.process_many"}
OFFLINE_TREE = {"engine.enhance_waveforms": None, "engine.pad": "engine.enhance_waveforms",
                "engine.upload": "engine.pad", "engine.launch": "engine.enhance_waveforms",
                "engine.fetch": "engine.enhance_waveforms",
                "engine.unpad": "engine.enhance_waveforms"}


@pytest.fixture(scope="module")
def pool():
    cfg = get_config("dpdfnet2")
    eng = Engine(cfg, contract_params(init_params(cfg, seed=0, device="cpu")), device="cpu")
    p = MultiStreamEnhancer(capacity=3, engine=eng)
    for _ in range(3):
        p.open()
    p.process_many({s: np.zeros(cfg.win_len, np.float32) for s in range(3)})
    return p


@pytest.fixture(autouse=True)
def clean():
    telemetry.reset()
    yield
    telemetry.reset()


def _calls(pool, which="both"):
    """One process_many of two of the pool's three streams, then one
    enhance_waveforms of two utterances (``which``: "live", "offline")."""
    cfg = pool._engine.cfg
    rng = np.random.default_rng(0)
    if which != "offline":
        pool.process_many({s: (0.1 * rng.normal(size=2 * cfg.hop)).astype(np.float32)
                           for s in (0, 2)})
    if which != "live":
        pool._engine.enhance_waveforms((0.1 * rng.normal(size=(2, 3000))).astype(np.float32),
                                       lengths=np.array([3000, 2000]))


def _check_tree(recs):
    """Every span's parent as the trees say, one call id per root, and the
    self times of each call adding up to its root's duration."""
    by_id = {s.id: s for s in recs}
    roots = [s for s in recs if s.parent is None]
    assert [r.name for r in roots] == ["pool.process_many", "engine.enhance_waveforms"]
    for root, tree in zip(roots, (POOL_TREE, OFFLINE_TREE)):
        mine = [s for s in recs if s.call == root.call]
        assert {s.name for s in mine} == set(tree)
        for s in mine:
            parent = by_id.get(s.parent)
            assert (parent.name if parent else None) == tree[s.name]
            assert parent is None or parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        own = telemetry.self_ns(mine)
        assert all(v >= 0 for v in own.values())
        assert sum(own.values()) == root.ns
    assert len({r.call for r in roots}) == 2


def test_off_records_nothing_and_enters_no_range(pool, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert not telemetry.enabled()
    assert telemetry.span("a", card=0) is telemetry.span("b")
    telemetry.count("engine.h2d_bytes", 10)
    _calls(pool)
    assert telemetry.spans() == [] and telemetry.counters() == {}
    assert telemetry.snapshot() == {"spans": {}, "counters": {}}


def test_profiler_records_every_cpu_span(pool):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.enabled()
        _calls(pool)
    assert not telemetry.enabled()
    recs = telemetry.spans()
    _check_tree(recs)
    assert [s.name for s in recs].count("pool.state") == 2     # gather, scatter
    ranges = {ev.name for ev in prof.events()}
    assert set(POOL_TREE) | set(OFFLINE_TREE) <= ranges
    snap = telemetry.snapshot()
    assert snap["spans"]["engine.upload"]["count"] == 2
    assert all(s.card is None for s in recs if s.name == "engine.upload")
    # nothing crosses to a card here; the live call staged one chunk length
    assert snap["counters"] == {"pool.stage_lengths": 1}


def test_recording_records_the_same_spans_without_a_profiler(pool, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    with telemetry.recording():
        assert telemetry.enabled()
        _calls(pool)
    assert not telemetry.enabled()
    _check_tree(telemetry.spans())


@pytest.mark.parametrize("lengths", [(1, 1, 1), (1, 2, 3), (1, 3, 3)])
def test_stage_counts_distinct_chunk_lengths(pool, lengths):
    """``pool.stage_lengths`` counts the distinct chunk lengths a call
    staged (one write when 1); ``pool.stage`` records once a call,
    ``pool.frame`` and ``pool.overlap_add`` once per hop bucket."""
    hop = pool._engine.cfg.hop
    rng = np.random.default_rng(1)
    with telemetry.recording():
        pool.process_many({s: (0.1 * rng.normal(size=k * hop)).astype(np.float32)
                           for s, k in enumerate(lengths)})
    snap = telemetry.snapshot()
    assert snap["counters"] == {"pool.stage_lengths": len(set(lengths))}
    buckets = len(set(lengths))                 # every slot buffered win - hop before
    assert {k: snap["spans"][k]["count"] for k in ("pool.process_many", "pool.stage",
                                                   "pool.frame", "pool.overlap_add")} == \
        {"pool.process_many": 1, "pool.stage": 1, "pool.frame": buckets,
         "pool.overlap_add": buckets}


def test_snapshot_sums_by_name_and_reads_since(monkeypatch):
    with telemetry.recording():
        with telemetry.span("outer"):
            with telemetry.span("inner", card=1):
                telemetry.count("engine.h2d_bytes", 100)
            with telemetry.span("inner"):
                pass
        t = time.perf_counter()
        with telemetry.span("later"):
            telemetry.count("engine.h2d_bytes", 7)
    telemetry.count("engine.h2d_bytes", 1000)           # off again
    snap = telemetry.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert inner["count"] == 2 and inner["self_ns"] == inner["total_ns"]
    assert outer["count"] == 1 and outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert snap["counters"] == {"engine.h2d_bytes": 107}
    late = telemetry.snapshot(since_s=t)
    assert set(late["spans"]) == {"later"} and late["counters"] == {"engine.h2d_bytes": 7}
    recs = telemetry.spans()
    assert len({s.call for s in recs}) == 2 and recs[1].card == 1


def test_threads_keep_separate_stacks():
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with telemetry.span(f"{tag}.root"):
            barrier.wait()
            with telemetry.span(f"{tag}.child"):
                barrier.wait()

    with telemetry.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert not any(th.is_alive() for th in threads)
    recs = {s.name: s for s in telemetry.spans()}
    assert len(recs) == 4
    for tag in ("a", "b"):
        root, child = recs[f"{tag}.root"], recs[f"{tag}.child"]
        assert root.parent is None and child.parent == root.id and child.call == root.call
        assert child.thread == root.thread
    assert recs["a.root"].call != recs["b.root"].call
    assert recs["a.root"].thread != recs["b.root"].thread


def test_cap_counts_dropped_records(monkeypatch):
    monkeypatch.setattr(telemetry, "CAP", 3)
    with telemetry.recording():
        for _ in range(5):
            with telemetry.span("s"):
                telemetry.count("c", 1)
    assert len(telemetry.spans()) == 3
    assert telemetry.counters() == {"c": 3, telemetry.DROPPED: 4}
    telemetry.reset()
    assert telemetry.counters() == {} and telemetry.spans() == []


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_test_reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_traced_run_and_nothing_before_one(pool, name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    read = _reader(name)
    t0 = time.perf_counter()
    assert read({"t0": t0, "log": [{"t1": t0}]}) is None        # no span since t0
    with profile(activities=[ProfilerActivity.CPU]):
        _calls(pool, READERS[name])
    log = [{"t0": t0, "t1": time.perf_counter()}]               # the window's logged call
    got = read({"t0": t0, "log": log})
    assert isinstance(got, float) and got >= 0.0
    if name in ("pool.loops_ms", "engine.fetch_ms", "engine.pad_ms", "engine.launch_ms"):
        assert got > 0.0                                        # spans the CPU path runs
    assert read({"t0": t0, "log": []}) is None                  # no call logged
    t1 = time.perf_counter()
    assert read({"t0": t1, "log": [{"t1": t1}]}) is None


def _ev(name, a_us, b_us, cuda=True, idx=0, annotation=False):
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dev, device_index=idx,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=a_us, end=b_us))


def test_profile_device_view_unions_busy_and_names_idle_by_span():
    evs = [
        _ev(profile_lib.RUN, 0, 1000, cuda=False),
        _ev("engine.process_frames", 120, 900, cuda=False),
        _ev("engine.replay", 150, 300, cuda=False),
        _ev("engine.fetch", 600, 900, cuda=False),
        _ev("engine.replay", 150, 300, annotation=True),      # the range's device mirror
        _ev("kernel_a", 200, 400), _ev("kernel_b", 300, 500),  # overlap: union 300
        _ev("kernel_c", 950, 1100),                            # clipped: 50
    ]
    view = profile_lib.device_view(evs, {"engine.process_frames", "engine.replay",
                                         "engine.fetch"})
    assert view["busy_us"] == {0: 350}
    # idle: [0, 200) outside, [500, 950) in fetch (its middle at 725)
    assert view["idle_us"] == {profile_lib.OUTSIDE: 200, "engine.fetch": 450}
    assert profile_lib.device_view(evs[1:], set()) == {"busy_us": {}, "idle_us": {}}


def test_profile_idle_goes_to_the_covering_span_past_many_children():
    # 200 short spans begin and end inside fetch before the gap's middle
    evs = [_ev(profile_lib.RUN, 0, 10_000, cuda=False),
           _ev("engine.fetch", 100, 9_000, cuda=False)]
    evs += [_ev("engine.upload", 200 + 10 * i, 205 + 10 * i, cuda=False) for i in range(200)]
    evs += [_ev("kernel_a", 0, 5_000), _ev("kernel_b", 7_000, 10_000)]
    view = profile_lib.device_view(evs, {"engine.fetch", "engine.upload"})
    assert view["busy_us"] == {0: 8_000}
    assert view["idle_us"] == {"engine.fetch": 2_000}
