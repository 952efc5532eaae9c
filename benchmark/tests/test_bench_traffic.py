"""The kinds' generators: the same seed gives the same inputs and
schedule; every seed gives the same work."""

import numpy as np
import pytest
import torch

from helpers import ROOT

from benchmark.harness.cells import Spec

CPU = torch.device("cpu")
SMALL_OFFLINE = {"utterances": 24, "batch": 8, "compare_per_batch": 2}
SMALL_LIVE = {"streams": 6, "compare_streams": 3, "loop_s": 0.2, "burst": [1, 2, 3]}


def _gen(mix_name, cfg_name, seed, over):
    spec = Spec(ROOT)
    mix = dict(spec.traffic(mix_name), **over)
    return spec.kind(mix["kind"]).generate(mix, spec.config(cfg_name), seed, CPU)


def test_offline_same_seed_same_corpus_and_order():
    a = _gen("offline_b64", "dpdfnet2", 2 ** 31 + 3, SMALL_OFFLINE)
    b = _gen("offline_b64", "dpdfnet2", 2 ** 31 + 3, SMALL_OFFLINE)
    assert np.array_equal(a.order, b.order)
    for x, y in zip(a.batches, b.batches):
        assert np.array_equal(x.wavs, y.wavs) and np.array_equal(x.lengths, y.lengths)
        assert x.compare == y.compare


def test_offline_every_seed_the_same_work():
    a = _gen("offline_b64", "dpdfnet2", 1, SMALL_OFFLINE)
    b = _gen("offline_b64", "dpdfnet2", 2, SMALL_OFFLINE)
    assert [x.lengths.tolist() for x in a.batches] == [x.lengths.tolist() for x in b.batches]
    assert not np.array_equal(a.batches[0].wavs, b.batches[0].wavs)
    # the batches go in index order every pass, whatever the seed
    assert np.array_equal(a.order, b.order) and a.order[:4].tolist() == [0, 1, 2, 0]


def test_offline_batches_sorted_padded_and_compared():
    t = _gen("offline_b64", "dpdfnet2", 9, SMALL_OFFLINE)
    lengths = np.concatenate([b.lengths for b in t.batches])
    assert np.all(np.diff(lengths) >= 0) and len(lengths) == 24
    sr = 16000
    assert lengths.min() >= 1.0 * sr and lengths.max() <= 20.0 * sr
    for b in t.batches:
        assert b.wavs.shape == (8, b.lengths.max())
        for row, n in enumerate(b.lengths):
            assert not np.any(b.wavs[row, n:])
        assert b.compare[-1] == 7 and b.compare[0] < 4       # the longest, and one of the first half


def test_live_same_seed_same_streams_and_schedule():
    a = _gen("live_n112", "dpdfnet8_48khz_hr", 2 ** 33 + 1, SMALL_LIVE)
    b = _gen("live_n112", "dpdfnet8_48khz_hr", 2 ** 33 + 1, SMALL_LIVE)
    assert np.array_equal(a.audio, b.audio) and np.array_equal(a.bursts, b.bursts)
    assert a.compare == b.compare
    c = _gen("live_n112", "dpdfnet8_48khz_hr", 5, SMALL_LIVE)
    assert sorted(c.bursts[:3].tolist()) == [1, 2, 3]
    assert not np.array_equal(a.audio, c.audio)


def test_live_chunks_follow_the_loop():
    t = _gen("live_n112", "dpdfnet8_48khz_hr", 4, SMALL_LIVE)
    hops = t.loop // t.hop + 5                          # past the loop's end
    sig = t.signal(2, hops)
    got = np.concatenate([t.chunk(k, 1)[2] for k in range(hops)])
    assert np.array_equal(got, sig)
    assert np.array_equal(t.chunk(hops - 3, 3)[2], sig[-3 * t.hop:])


def test_live_rejects_a_hop_the_model_does_not_have():
    with pytest.raises(ValueError):
        _gen("live_n112", "dpdfnet2", 1, dict(SMALL_LIVE, hop_ms=20.0))
