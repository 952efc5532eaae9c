"""A later PR adds a configuration, a mix, a kind of traffic, a cell and
per-layer metrics by adding files and entries, editing no file of the
benchmark: shown in a temporary copy."""

import hashlib
import json
import shutil

import pytest

from helpers import ROOT, run_module

from benchmark.harness.cells import Spec, lookup

# a kind of traffic the benchmark does not have: utterances one at a
# time through ``enhance_waveforms``, with an end-to-end metric of its own
SINGLE_KIND = '''
"""Utterances one at a time through ``Engine.enhance_waveforms``."""
import time

import numpy as np
import torch

from benchmark.harness import audio, check
from benchmark.reference import dpdfnet_ref as ref

SPANS = ("single.enhance",)


def generate(mix, cfg, seed, device):
    return audio.make(int(mix["utterances"]), int(mix["samples"]), int(cfg["sample_rate"]),
                      0.05, seed, device)


class Driver:
    def __init__(self, engine, wavs, spans):
        self.engine, self.wavs, self.span = engine, wavs, spans
        self.log, self.kept, self.attempted, self.failed = [], {}, 0, 0

    def _run(self, i):
        with self.span("single.enhance"):
            return self.engine.enhance_waveforms(self.wavs[i:i + 1])[0]

    def warmup(self):
        self._run(0)

    def window(self, seconds):
        self.t0 = time.perf_counter()
        while time.perf_counter() - self.t0 < seconds:
            i = len(self.log) % len(self.wavs)
            a = time.perf_counter()
            self.kept[i] = self._run(i)
            e = time.perf_counter()
            self.log.append({"t0": a, "t1": e, "engine_s": e - a, "in_window": True,
                             "frames": 1.0, "launches": [1, 1, 1]})
            self.attempted += 1

    def end_to_end(self):
        return {"utterances_per_s": len(self.log) / (self.log[-1]["t1"] - self.t0)}

    def answers(self):
        return self.kept

    def due(self):
        return list(range(min(len(self.log), len(self.wavs))))

    def release(self):
        self.engine = None


def planned(wavs, seconds):
    return list(range(len(wavs)))


def references(params, cfg, wavs, keys, device, tf32=False):
    S = wavs.shape[1]
    x = np.zeros((len(keys), S + 4 * int(cfg["n_fft"])), np.float32)
    x[:, :S] = wavs[keys]
    with check.math_mode(tf32), torch.inference_mode():
        y = ref.enhance_offline(params, cfg, torch.as_tensor(x, device=device)).cpu().numpy()
    return {k: y[i, :S] for i, k in enumerate(keys)}
'''


def _digests(d):
    return {p.relative_to(d).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    return bench, _digests(bench)


def _add_config(bench, doc):
    cfg = json.loads((bench / "configs" / "dpdfnet2.json").read_text())
    cfg.update(name="dpdfnet4", dprnn_blocks=4)
    (bench / "configs" / "dpdfnet4.json").write_text(json.dumps(cfg))
    doc["configs"].append({"name": "dpdfnet4", "source": "https://github.com/ceva-ip/DPDFNet",
                           "file": "benchmark/configs/dpdfnet4.json", "reduced": [],
                           "why": "a test"})


def _add_cell(bench, doc, name, traffic):
    (bench / "limits" / f"{name}.json").write_text(json.dumps(
        {"rel_rms": 1e-5, "max_gap": 1e-4, "missing": 0}))
    doc["workloads"].append({"name": name, "config": "dpdfnet4", "traffic": traffic,
                             "chips": 1, "why": "a test"})


def test_add_cell_config_mix_and_metric_by_files_only(tmp_path):
    bench, before = _copy(tmp_path)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _add_config(bench, doc)
    (bench / "traffic" / "offline_tiny.json").write_text(json.dumps({
        "kind": "offline", "utterances": 4, "batch": 2, "median_s": 0.4, "sigma_ln": 0.3,
        "min_s": 0.3, "max_s": 0.5, "level_rms": 0.05, "compare_per_batch": 2}))
    _add_cell(bench, doc, "dn4.offline", "offline_tiny")
    (bench / "metrics" / "batches.offline.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx['log']))\n")
    for m in doc["end_to_end"]:
        if m["name"] == "offline_xrt":
            m["workloads"].append("dn4.offline")
    doc["per_layer"].append({"name": "batches.offline", "unit": "1", "better": "higher",
                             "source": "host_clock", "layer": "engine: runtime/engine.py",
                             "moves": "offline_xrt", "workloads": ["dn4.offline"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    assert {k: v for k, v in _digests(bench).items() if k in before} == before
    run = run_module(tmp_path)
    spec = Spec(tmp_path)
    cell = spec.cell("dn4.offline")
    out = run.run_cell(spec, cell, 77, 2.0, False, device="cpu")
    assert out["correct"] and set(out["metrics"]) == {"setup_s", "offline_xrt"}
    out = run.run_cell(spec, cell, 78, 2.0, True, device="cpu")
    assert out["correct"] and out["metrics"]["batches.offline"]["value"] >= 1


def test_add_a_kind_of_traffic_by_files_only(tmp_path):
    """A new kind (``kinds/single.py``), its mix, a cell, its own end-to-end
    metric, a per-layer metric with a reader of its own, and one that an
    existing reader serves under the name's last dotted part."""
    bench, before = _copy(tmp_path)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _add_config(bench, doc)
    (bench / "kinds" / "single.py").write_text(SINGLE_KIND)
    (bench / "traffic" / "single_short.json").write_text(json.dumps(
        {"kind": "single", "utterances": 3, "samples": 4000}))
    _add_cell(bench, doc, "dn4.single", "single_short")
    (bench / "metrics" / "utterance_ms.py").write_text(
        "def read(ctx):\n"
        "    log = ctx['log']\n"
        "    return 1e3 * sum(c['t1'] - c['t0'] for c in log) / len(log) if log else None\n")
    doc["end_to_end"].append({"name": "utterances_per_s", "unit": "1/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["dn4.single"]})
    for name, layer in (("utterance_ms.single", "engine: runtime/engine.py"),
                        ("pool.host_ms.single", "pool: serving.py")):
        doc["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                 "source": "host_clock", "layer": layer,
                                 "moves": "utterances_per_s", "workloads": ["dn4.single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    assert {k: v for k, v in _digests(bench).items() if k in before} == before
    run = run_module(tmp_path)
    spec = Spec(tmp_path)
    cell = spec.cell("dn4.single")
    out = run.run_cell(spec, cell, 2 ** 31 + 79, 1.0, False, device="cpu")
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"setup_s", "utterances_per_s"}
    out = run.run_cell(spec, cell, 2 ** 31 + 80, 1.0, True, device="cpu")
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"utterance_ms.single", "pool.host_ms.single"}


def test_a_metric_is_found_by_its_name_or_its_name_less_the_last_part():
    files = {"dprnn_roofline", "pool.host_ms.live", "offline_xrt"}
    assert lookup("pool.host_ms.live", files) == "pool.host_ms.live"
    assert lookup("dprnn_roofline.mesh4", files) == "dprnn_roofline"
    assert lookup("offline_xrt.mesh4", files) == "offline_xrt"
    assert lookup("model.mfu.live", files) is None
    assert lookup("dprnn", files) is None
    with pytest.raises(FileNotFoundError):
        Spec(ROOT).reader("no_such.metric")
