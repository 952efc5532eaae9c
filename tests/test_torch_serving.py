"""The port's multi-stream pool against the JAX package's, and its slot
behaviours (``tests/test_serving.py`` pins them for JAX).

Weights: the JAX package's ``init_params`` + ``contract_params``, carried
across with ``params_from_jax``; signals from numpy seeds; dpdfnet2 on
the CPU (``device="cpu"`` on the port's side).  Tolerance 1e-4 max-abs
against JAX (as ``test_torch_stream.py``), 1e-5 between the port's pool
and a lone port stream (batch 4 against batch 1, the same kernels), bit
equality where the batch shape is the same.
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

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.serving import MultiStreamEnhancer
from dpdfnet_tpu_torch.stream import StreamEnhancer
from dpdfnet_tpu_torch.utils.serialization import params_from_jax

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
