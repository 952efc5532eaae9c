"""The port's ``fast`` and ``turbo`` quality tiers against the JAX package's
while streaming: ``process_frames`` in both modes with the state it
carries, and the port's own ``turbo`` streams (chunking, save / load, pool
slots).  The offline and ``forward_spec`` cases are in
``test_torch_tiers.py``, whose weights, inputs, engines and tolerances
(its module notes) these cases share.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.quality import speechlike_test_signal
from dpdfnet_tpu_torch.utils.tree import tree_leaves

from test_torch_tiers import _assert_matches_jax, _engines, _rel_rms

STATE_REL_RMS = 0.1


@pytest.mark.parametrize("name,quality,mode", [
    ("dpdfnet2", "fast", "exact"), ("dpdfnet2", "turbo", "exact"),
    ("dpdfnet2", "turbo", "throughput"), ("dpdfnet8_48khz_hr", "turbo", "exact")])
def test_process_frames_matches_jax_tier(name, quality, mode):
    """Two calls (5 frames, then 3 from the carried state) on each side,
    over frames cut from a speech-shaped signal; the outputs and the state
    carried out of the second call (see the module notes)."""
    j, t = _engines(name, quality)
    cfg = get_config(name)
    wav = speechlike_test_signal(9 * cfg.hop / cfg.sample_rate, cfg.sample_rate, seed=2, batch=2)
    frames = wav[:, np.arange(8)[:, None] * cfg.hop + np.arange(cfg.win_len)[None, :]]
    outs, states = [], []
    for eng in (j, t):
        st = eng.init_stream_state(batch=2)
        y1, st = eng.process_frames(frames[:, :5], st, mode=mode)
        y2, st = eng.process_frames(frames[:, 5:], st, mode=mode)
        outs.append(np.concatenate([y1, y2], axis=1))
        states.append(st)
    assert np.isfinite(outs[1]).all()
    _assert_matches_jax(outs[1], outs[0])
    ref = dict(tree_leaves(states[0]))
    got = dict(tree_leaves(states[1]))
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert str(v.dtype).replace("torch.", "") == str(jnp.dtype(ref[k].dtype)), k
        rel = _rel_rms(v.float().numpy(), np.asarray(ref[k]).astype(np.float32))
        assert rel <= STATE_REL_RMS, f"{k}: rel_rms {rel:.3e} > {STATE_REL_RMS}"


def test_turbo_exact_streaming_is_bit_invariant_to_chunking():
    _, t = _engines("dpdfnet2", "turbo")
    frames = (0.05 * np.random.default_rng(5).normal(size=(2, 7, t.cfg.win_len))).astype(np.float32)
    outs = []
    for cuts in ([7], [1] * 7, [3, 4]):
        st, ys, pos = t.init_stream_state(batch=2), [], 0
        for n in cuts:
            y, st = t.process_frames(frames[:, pos:pos + n], st)
            ys.append(y)
            pos += n
        outs.append(np.concatenate(ys, axis=1))
    for y in outs[1:]:
        np.testing.assert_array_equal(y, outs[0])


def test_turbo_stream_enhancer_save_load_is_bit_exact():
    """A ``turbo`` stream resumed from ``save_state`` continues bit-exactly,
    with every state leaf back at its live dtype."""
    from dpdfnet_tpu_torch.stream import StreamEnhancer

    _, t = _engines("dpdfnet2", "turbo")
    x = speechlike_test_signal(0.25, t.cfg.sample_rate, seed=6)[0]
    se = StreamEnhancer(engine=t)
    se.process(x[:1500])
    snap = se.save_state()
    live = {k: v.dtype for k, v in tree_leaves(se._state)}
    a = se.process(x[1500:])
    se2 = StreamEnhancer(engine=t)
    se2.load_state(snap)
    assert {k: v.dtype for k, v in tree_leaves(se2._state)} == live
    assert live["dprnn_df/0"] == torch.float32 and live["enc_gru/0"] == torch.bfloat16
    np.testing.assert_array_equal(se2.process(x[1500:]), a)


def test_turbo_pool_slots_match_lone_streams():
    """An 8-slot ``MultiStreamEnhancer`` on a ``turbo`` engine, mixed
    cadences and a slot reset mid-way (fresh slots come from the engine at
    its dtypes): each slot's output matches a lone ``StreamEnhancer``'s
    within 1e-7 (see the module notes)."""
    from dpdfnet_tpu_torch.serving import MultiStreamEnhancer
    from dpdfnet_tpu_torch.stream import StreamEnhancer

    _, t = _engines("dpdfnet2", "turbo")
    hop = t.cfg.hop
    xs = speechlike_test_signal(0.12, t.cfg.sample_rate, seed=7, batch=8)
    pool = MultiStreamEnhancer(capacity=8, engine=t)
    sids = [pool.open() for _ in range(8)]
    cad = [hop, 2 * hop, 3 * hop + 7, 300, 5 * hop, hop // 2, 999, 4 * hop]
    outs = {s: [] for s in sids}
    pos = {s: 0 for s in sids}
    pool.process(3, xs[3][:500])
    pool.reset(3)
    while any(pos[s] < xs.shape[1] for s in sids):
        feed = {s: xs[s][pos[s]:pos[s] + cad[s]] for s in sids if pos[s] < xs.shape[1]}
        for s in feed:
            pos[s] += cad[s]
        for s, y in pool.process_many(feed).items():
            outs[s].append(y)
    assert {str(v.dtype) for _, v in tree_leaves(pool._state)} == {"torch.bfloat16",
                                                                    "torch.float32"}
    for s in sids:
        lone = StreamEnhancer(engine=t)
        ref = np.concatenate([lone.process(xs[s]), lone.flush()])
        got = np.concatenate(outs[s] + [pool.flush(s)])
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-7)
