"""The plain reference against the program's plain path on the CPU, at a
small size, for both configurations, offline and live; and what the
reference may import."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import ROOT, run_module

from benchmark.harness import weights
from benchmark.harness.cells import Spec
from benchmark.reference import dpdfnet_ref as ref

CONFIGS = ("dpdfnet8_48khz_hr", "dpdfnet2")
# float32 on both sides, other summation orders: 1e-7 to 1e-6 seen
TOL_REL_RMS = 1e-5


def _setup(name, seed=5):
    cfg = Spec(ROOT).config(name)
    params = weights.make(cfg, seed, torch.device("cpu"))
    engine = run_module().build_engine(cfg, weights.clone(params), [torch.device("cpu")])
    return cfg, params, engine


def _audio(rows, samples, seed):
    return (0.05 * np.random.default_rng(seed).standard_normal((rows, samples))).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_offline_path(name):
    cfg, params, engine = _setup(name)
    sr = cfg["sample_rate"]
    lengths = np.array([int(0.3 * sr), int(0.22 * sr)])
    wavs = _audio(2, lengths[0], 1)
    wavs[1, lengths[1]:] = 0.0
    got = engine.enhance_waveforms(wavs, lengths=lengths)
    x = np.zeros((2, lengths[0] + 4 * cfg["n_fft"]), np.float32)
    x[:, :lengths[0]] = wavs
    with torch.inference_mode():
        want = ref.enhance_offline(params, cfg, torch.as_tensor(x)).numpy()
    for i, n in enumerate(lengths):
        rel, _ = ref.gap(got[i, :n], want[i, :n])
        assert rel < TOL_REL_RMS, (i, rel)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_pool(name):
    from dpdfnet_tpu_torch.serving import MultiStreamEnhancer

    cfg, params, engine = _setup(name)
    hop, hops = cfg["hop"], 24
    sig = _audio(2, hops * hop, 2)
    pool = MultiStreamEnhancer(capacity=2, engine=engine, mode="exact")
    sids = [pool.open(), pool.open()]
    outs = {s: [] for s in sids}
    for k in range(0, hops, 3):                  # three hops a call
        out = pool.process_many({s: sig[s, k * hop:(k + 3) * hop] for s in sids})
        for s in sids:
            outs[s].append(out[s])
    with torch.inference_mode():
        want = ref.enhance_stream(params, cfg, torch.as_tensor(sig)).numpy()
    for s in sids:
        got = np.concatenate(outs[s])
        assert got.shape == want[s].shape == ((hops - 1) * hop,)
        rel, _ = ref.gap(got, want[s])
        assert rel < TOL_REL_RMS, (s, rel)


def test_reference_sees_a_wrong_weight():
    """The comparison is not blind: one weight of the program's tree
    changed by 1% moves the output far past the tolerance."""
    cfg, params, _ = _setup("dpdfnet2")
    bad = weights.clone(params)
    bad["enc"]["dprnn_erb"][0]["inter"]["gru"]["wh"] *= 1.01
    engine = run_module().build_engine(cfg, bad, [torch.device("cpu")])
    n = int(0.3 * cfg["sample_rate"])
    wavs = _audio(1, n, 3)
    got = engine.enhance_waveforms(wavs)
    x = np.concatenate([wavs, np.zeros((1, 4 * cfg["n_fft"]), np.float32)], axis=1)
    with torch.inference_mode():
        want = ref.enhance_offline(params, cfg, torch.as_tensor(x)).numpy()
    assert ref.gap(got[0], want[0, :n])[0] > 10 * TOL_REL_RMS


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"dpdfnet_tpu_torch", "dpdfnet_tpu", "jax", "jaxlib", "flax"}, f
