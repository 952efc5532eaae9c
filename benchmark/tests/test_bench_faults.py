"""``correct`` comes out false when the timed path is broken underneath.

Each case drives the rest of a run on the CPU (tiny mixes, the cell's own
limits) with one fault planted in the program's engine:

- a step that returns its state unchanged (live: ``process_frames``;
  offline: the segment step, on utterances longer than a segment);
- half of the batch left out (offline: the second half's answers zero);
- the exchange between cards left out (the mesh cell: the shards after
  the first never gathered);
- an answer altered where it is produced (every output scaled by 1.001).
"""

import numpy as np
import pytest

from helpers import tiny_run

from dpdfnet_tpu_torch.runtime.engine import Engine


def _state_unchanged_live(mp):
    orig = Engine.process_frames

    def fault(self, frames, st, mode="exact"):
        y, _ = orig(self, frames, st, mode=mode)
        return y, st
    mp.setattr(Engine, "process_frames", fault)


def _answer_altered_live(mp):
    orig = Engine.process_frames

    def fault(self, frames, st, mode="exact"):
        y, st = orig(self, frames, st, mode=mode)
        return y * np.float32(1.001), st
    mp.setattr(Engine, "process_frames", fault)


def _state_unchanged_offline(mp):
    orig = Engine._segment

    def fault(self, spec_seg, st):
        out, _ = orig(self, spec_seg, st)
        return out, st
    mp.setattr(Engine, "_segment", fault)


def _half_batch_offline(mp):
    orig = Engine.enhance_waveforms

    def fault(self, wavs, *a, **k):
        y = orig(self, wavs, *a, **k)
        y[y.shape[0] // 2:] = 0.0
        return y
    mp.setattr(Engine, "enhance_waveforms", fault)


def _answer_altered_offline(mp):
    orig = Engine.enhance_waveforms

    def fault(self, wavs, *a, **k):
        return orig(self, wavs, *a, **k) * np.float32(1.001)
    mp.setattr(Engine, "enhance_waveforms", fault)


def _exchange_left_out(mp):
    orig = Engine._offline_shards

    def fault(self, wavs, *a, **k):
        ys = orig(self, wavs, *a, **k)
        return [ys[0]] + [y.new_zeros(y.shape) for y in ys[1:]]
    mp.setattr(Engine, "_offline_shards", fault)


LONG = {"median_s": 1.3, "min_s": 1.25, "max_s": 1.35}     # two 112-frame segments

CASES = [
    ("dn2.live", _state_unchanged_live, {}),
    ("dn2.live", _answer_altered_live, {}),
    ("hr8.live", _state_unchanged_live, {}),
    ("hr8.offline", _state_unchanged_offline, LONG),
    ("hr8.offline", _half_batch_offline, {}),
    ("hr8.offline", _answer_altered_offline, {}),
    ("hr8.offline.mesh4", _exchange_left_out, {}),
]


@pytest.mark.parametrize("workload,fault,over", CASES,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f, _ in CASES])
def test_fault_makes_the_run_incorrect(monkeypatch, workload, fault, over):
    import helpers

    monkeypatch.setitem(helpers.TINY, "offline", dict(helpers.TINY["offline"], **over))
    chips = 2 if workload.endswith("mesh4") else None
    seconds = 0.5 if "live" in workload else 4.0
    sound = tiny_run(workload, seconds=seconds, chips=chips)
    assert sound["correct"], sound["check"]
    fault(monkeypatch)
    out = tiny_run(workload, seconds=seconds, chips=chips)
    assert out["correct"] is False, out["check"]
