"""The port's multi-stream pool against the JAX package's, and its slot
behaviours (``tests/test_serving.py`` pins them for JAX).

Weights: the JAX package's ``init_params`` + ``contract_params``, carried
across with ``params_from_jax``; signals from numpy seeds; dpdfnet2 on
the CPU (``device="cpu"`` on the port's side).  Tolerance 1e-4 max-abs
against JAX (as ``test_torch_stream.py``), 1e-5 between the port's pool
and a lone port stream (batch 4 against batch 1, the same kernels), bit
equality where the batch shape is the same, and against ``_ListPool``, the
pool written as per-stream loops over lists.
"""

import functools

import numpy as np
import pytest
import jax
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import params as jax_params
from dpdfnet_tpu.runtime.engine import Engine as JaxEngine
from dpdfnet_tpu.serving import MultiStreamEnhancer as JaxMultiStreamEnhancer

from dpdfnet_tpu_torch.audio import to_mono
from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.serving import MultiStreamEnhancer
from dpdfnet_tpu_torch.stream import StreamEnhancer
from dpdfnet_tpu_torch.utils.serialization import params_from_jax
from dpdfnet_tpu_torch.utils.tree import tree_map, tree_map2

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _engines():
    cfg_j = jax_get_config("dpdfnet2")
    p = jax.tree_util.tree_map(
        np.asarray, jax_params.contract_params(jax_params.init_params(cfg_j, seed=3)))
    return (JaxEngine(cfg_j, p, precision="highest"),
            Engine(get_config("dpdfnet2"), params_from_jax(p, device="cpu"),
                   precision="highest", device="cpu"))


@pytest.fixture(scope="module")
def engine():
    return _engines()[1]


def _sig(seed, n=2400):
    return (0.1 * np.random.default_rng(seed).normal(size=n)).astype(np.float32)


def _mixed_cadence_run(pool):
    """Three streams on a pool of 4, fed at different cadences: every call
    mixes slots with 0, 1 and several new hops (gather / scatter path)."""
    sids = [pool.open() for _ in range(3)]
    xs = [_sig(20 + i) for i in range(3)]
    cuts = [(0, 500, 900, 2400), (0, 160, 1760, 2400), (0, 1300, 1310, 2400)]
    outs = {sid: [] for sid in sids}
    for step in range(3):
        res = pool.process_many({sid: xs[i][cuts[i][step]:cuts[i][step + 1]]
                                 for i, sid in enumerate(sids)})
        for sid in sids:
            outs[sid].append(res[sid])
    for sid in sids:
        outs[sid].append(pool.flush(sid))
    return [np.concatenate(outs[sid]) for sid in sids], xs


@pytest.mark.parametrize("mode", ["exact", "throughput"])
def test_pool_matches_jax_pool(mode):
    jeng, teng = _engines()
    ref, _ = _mixed_cadence_run(JaxMultiStreamEnhancer(capacity=4, engine=jeng, mode=mode))
    got, _ = _mixed_cadence_run(MultiStreamEnhancer(capacity=4, engine=teng, mode=mode))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-4)


def test_pool_slots_match_lone_streams(engine):
    got, xs = _mixed_cadence_run(MultiStreamEnhancer(capacity=4, engine=engine))
    for g, x in zip(got, xs):
        se = StreamEnhancer(engine=engine)
        np.testing.assert_allclose(g, np.concatenate([se.process(x), se.flush()]), atol=1e-5)


def test_pool_slot_isolation_on_reset(engine):
    pool = MultiStreamEnhancer(capacity=3, engine=engine)
    a, b = pool.open(), pool.open()
    x = _sig(3)
    ya1 = pool.process(a, x)
    yb1 = pool.process(b, _sig(4))
    pool.reset(a)
    np.testing.assert_array_equal(pool.process(a, x), ya1)   # reset cleared slot a
    ref = MultiStreamEnhancer(capacity=3, engine=engine)
    ref.open()
    rb = ref.open()
    np.testing.assert_array_equal(ref.process(rb, _sig(4)), yb1)
    # b is unaffected by a's reset
    np.testing.assert_array_equal(pool.process(b, _sig(5)), ref.process(rb, _sig(5)))


def test_pool_capacity_and_close(engine, tmp_path, monkeypatch):
    pool = MultiStreamEnhancer(capacity=2, engine=engine)
    sid = pool.open()
    pool.open()
    with pytest.raises(RuntimeError, match="busy"):
        pool.open()
    pool.close(sid)
    assert pool.open() == sid
    with pytest.raises(ValueError):
        pool.process(99, np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="mode"):
        MultiStreamEnhancer(capacity=2, engine=engine, mode="banana")
    # without engine= the pool resolves its model by name through the zoo;
    # with no weights cached and the download failing, that raises
    from urllib.error import HTTPError

    from dpdfnet_tpu_torch import zoo

    def no_download(url, destination):
        raise HTTPError(url, 404, "not found", hdrs=None, fp=None)

    monkeypatch.setenv("DPDFNET_TPU_MODEL_DIR", str(tmp_path))
    monkeypatch.setattr(zoo, "_download_one", no_download)
    with pytest.raises(RuntimeError, match="HTTP 404"):
        MultiStreamEnhancer(capacity=2, device="cpu")


def test_process_many_order_insensitive_identity(engine):
    """A full pool fed in any dict order matches slot-order feeding."""
    hop = engine.cfg.hop
    xs = {i: _sig(10 + i, 4 * hop) for i in range(3)}
    outs = []
    for order in ((0, 1, 2), (2, 0, 1)):
        pool = MultiStreamEnhancer(capacity=3, engine=engine)
        for _ in range(3):
            pool.open()
        outs.append(pool.process_many({i: xs[i] for i in order}))
    for i in range(3):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])


def test_process_many_invalid_sid_is_atomic(engine):
    """A bad sid anywhere in the dict leaves every buffer untouched."""
    x = _sig(30, 6 * engine.cfg.hop)
    pool = MultiStreamEnhancer(capacity=2, engine=engine)
    sid = pool.open()
    ref_pool = MultiStreamEnhancer(capacity=2, engine=engine)
    ref = ref_pool.process(ref_pool.open(), x)
    with pytest.raises(ValueError):
        pool.process_many({sid: x, 99: x})
    np.testing.assert_array_equal(pool.process(sid, x), ref)
    full = MultiStreamEnhancer(capacity=2, engine=engine)
    a, b = full.open(), full.open()
    full.close(b)
    with pytest.raises(ValueError, match="stream id 1 "):
        full.process_many({a: x, b: x})         # every slot in slot order, one closed
    np.testing.assert_array_equal(full.process(a, x), ref)


class _ListPool:
    """The pool as it was before its host state became pool-wide arrays:
    one buffer list entry per slot and per-stream loops for stage, frame
    and overlap-add; the same engine calls, state gather and scatter.  The
    reference the array pool is held to bit for bit."""

    def __init__(self, capacity, engine, mode="exact"):
        self._engine, self.mode, self.capacity = engine, mode, capacity
        self._win, self._hop = engine.cfg.win_len, engine.cfg.hop
        self._state = engine.init_stream_state(batch=capacity)
        self._in_buf = [np.zeros(0, np.float32) for _ in range(capacity)]
        self._ola_tail = np.zeros((capacity, self._win - self._hop), np.float32)
        self._open = [False] * capacity

    def open(self):
        sid = self._open.index(False)
        self._open[sid] = True
        self.reset(sid)
        return sid

    def close(self, sid):
        self._open[sid] = False

    def reset(self, sid):
        fresh = self._engine.init_stream_state(batch=1)
        rows = torch.tensor([sid])
        self._state = tree_map2(lambda cur, new: cur.index_copy(0, rows, new), self._state, fresh)
        self._in_buf[sid] = np.zeros(0, np.float32)
        self._ola_tail[sid] = 0.0

    def process_many(self, chunks):
        for sid, c in chunks.items():
            self._in_buf[sid] = np.concatenate([self._in_buf[sid], to_mono(c)])
        counts = {sid: max(0, (len(self._in_buf[sid]) - self._win) // self._hop + 1)
                  for sid in chunks}
        out = {sid: np.zeros(0, np.float32) for sid in chunks}
        groups = {}
        for sid, n in counts.items():
            if n > 0:
                groups.setdefault(n, []).append(sid)
        for n, sids in sorted(groups.items()):
            sids = sorted(sids)
            g, gp = len(sids), self.capacity
            frames = np.zeros((gp, n, self._win), np.float32)
            fidx = np.arange(n)[:, None] * self._hop + np.arange(self._win)[None, :]
            for row, sid in enumerate(sids):
                frames[row] = self._in_buf[sid][fidx]
            if g == gp and sids == list(range(gp)):
                y, self._state = self._engine.process_frames(frames, self._state, mode=self.mode)
            else:
                idx = torch.tensor(sids + [sids[0]] * (gp - g))
                rows = torch.tensor(sids)
                sub = tree_map(lambda _, a: a.index_select(0, idx), self._state)
                y, sub = self._engine.process_frames(frames, sub, mode=self.mode)
                self._state = tree_map2(lambda cur, new: cur.index_copy(0, rows, new[:g]),
                                        self._state, sub)
            for row, sid in enumerate(sids):
                yf = y[row]
                tails = np.concatenate([self._ola_tail[sid][None], yf[:-1, self._hop:]], axis=0)
                out[sid] = (yf[:, : self._hop] + tails).reshape(-1)
                self._ola_tail[sid] = yf[-1, self._hop:]
                self._in_buf[sid] = self._in_buf[sid][n * self._hop:]
        return out

    def flush(self, sid):
        if self._in_buf[sid].size == 0:
            return np.zeros(0, np.float32)
        pad = np.zeros(self._win - len(self._in_buf[sid]), np.float32)
        out = self.process_many({sid: pad})[sid]
        return out[: min(self._hop, len(out))].astype(np.float32)


def _chunk(seed, n, stereo=False):
    shape = (n, 2) if stereo else (n,)
    return (0.1 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


# each script: the slots it opens on a pool of 4, then its steps; a step is
# {sid: chunk length} (negative: a [S, 2] stereo chunk), or ("reset", sid),
# ("close", sid), ("open",).  Every open stream is flushed at the end.
POOL_SCRIPTS = {
    "full_slot_order": (4, [{s: 320 for s in range(4)}] * 3),
    "full_shuffled_order": (4, [{s: 320 for s in (2, 0, 3, 1)}, {s: 160 for s in (3, 1, 0, 2)},
                                {s: 480 for s in (1, 3, 2, 0)}]),
    "mixed_cadences": (3, [{0: 500, 1: 160, 2: 1300}, {0: 400, 1: 1600, 2: 10},
                           {0: 1500, 1: 640, 2: 1090}]),
    "three_lengths": (4, [{0: 100, 1: 250, 2: 700, 3: 250}, {3: 90, 2: 410, 1: 160, 0: 90}]),
    "stereo": (4, [{s: -320 for s in range(4)}, {0: -200, 1: 160, 2: -500, 3: 160}]),
    "growth": (4, [{0: 160, 1: 160, 2: 3000, 3: 160}, {s: 160 for s in range(4)},
                   {0: 2500, 1: 1000, 2: 5, 3: 160}]),
    "reset_and_reopen": (4, [{s: 400 for s in range(4)}, ("reset", 0), ("close", 1),
                             {0: 400, 2: 320, 3: 100}, ("open",), {s: 330 for s in range(4)}]),
}


@pytest.mark.parametrize("case", POOL_SCRIPTS)
def test_array_pool_bit_equal_to_per_stream_loops(engine, case):
    """Every output of the pool, flushes included, equals the per-stream
    reference's bit for bit: the same float32 samples reach the engine in
    the same rows, and the overlap-add makes the same float32 adds."""
    opened, steps = POOL_SCRIPTS[case]
    pools = (MultiStreamEnhancer(capacity=4, engine=engine), _ListPool(4, engine))
    for pool in pools:
        assert [pool.open() for _ in range(opened)] == list(range(opened))
    live = set(range(opened))
    for k, step in enumerate(steps):
        if isinstance(step, tuple):
            got, ref = (getattr(p, step[0])(*step[1:]) for p in pools)
            assert got == ref                   # open: the same slot
            if step[0] == "close":
                live.discard(step[1])
            elif step[0] == "open":
                live.add(got)
            continue
        chunks = {sid: _chunk(100 * k + sid, abs(n), stereo=n < 0) for sid, n in step.items()}
        got, ref = (p.process_many(dict(chunks)) for p in pools)
        assert list(got) == list(chunks)
        for sid in chunks:
            assert got[sid].dtype == np.float32
            np.testing.assert_array_equal(got[sid], ref[sid])
    for sid in sorted(live):
        np.testing.assert_array_equal(pools[0].flush(sid), pools[1].flush(sid))


def test_returned_arrays_do_not_alias_the_pool(engine):
    """An array the pool returned stays as it was through later calls,
    shares no memory with the pool's buffers and owns its samples alone (a
    kept output does not hold the other streams' outputs)."""
    pool = MultiStreamEnhancer(capacity=3, engine=engine)
    sids = [pool.open() for _ in range(3)]
    kept = []
    for k, n in enumerate((480, 160, 160, 2000, 320, 320)):     # steady calls repeat
        got = pool.process_many({s: _chunk(50 * k + s, n) for s in sids})
        kept += [(y, y.copy()) for y in got.values()]
        assert all(y.base is None for y in got.values())
        for y, _ in kept:
            for buf in (pool._buf, pool._fill, pool._ola_tail):
                assert not np.shares_memory(y, buf)
    kept += [(y, y.copy()) for y in (pool.flush(s) for s in sids)]
    pool.process_many({s: _chunk(7 + s, 640) for s in sids})
    for y, was in kept:
        np.testing.assert_array_equal(y, was)
