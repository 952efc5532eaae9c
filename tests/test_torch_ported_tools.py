"""The port's tools and examples (``dpdfnet_tpu_torch.tools.tier_accuracy``,
``bench_sweep``, ``stream_sweep``, ``resampler_delta`` and
``dpdfnet_tpu_torch.examples.batch_enhance``, ``finetune``,
``serving_pool``), each through its ``main()`` on the CPU at a tiny size
(``dpdfnet2``).  The sweeps' measurements (``runtime.bench.run_bench``,
``run_stream_bench``) time the card, so they are stubbed here by fakes that
bind the real functions' signatures; ``tier_accuracy`` runs 0.5 s, the
shortest input its STOI column takes.
"""

import contextlib
import inspect
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpdfnet_tpu_torch.runtime import bench
from dpdfnet_tpu_torch.examples import batch_enhance, finetune, serving_pool
from dpdfnet_tpu_torch.tools import bench_sweep, resampler_delta, stream_sweep, tier_accuracy

import torch_testing  # noqa: F401  (the thread budget)

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["dpdfnet_tpu_torch.tools.tier_accuracy", "dpdfnet_tpu_torch.tools.bench_sweep",
           "dpdfnet_tpu_torch.tools.stream_sweep", "dpdfnet_tpu_torch.tools.resampler_delta",
           "dpdfnet_tpu_torch.examples.batch_enhance", "dpdfnet_tpu_torch.examples.finetune",
           "dpdfnet_tpu_torch.examples.serving_pool"]


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    assert rc == 0
    return buf.getvalue().strip().splitlines()


def _fake(real, calls, result):
    """A stand-in for ``real`` that checks its arguments against ``real``'s
    signature, records them and returns ``result(kwargs)`` as a JSON line."""
    sig = inspect.signature(real)

    def fake(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        calls.append(dict(bound.arguments))
        return json.dumps(result(bound.arguments))
    return fake


def test_every_tool_and_example_runs_as_a_module():
    code = ("import runpy, sys\n"
            f"for m in {MODULES!r}:\n"
            "    sys.argv = [m, '--help']\n"
            "    try:\n"
            "        runpy.run_module(m, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (m, e.code)\n"
            "    print('OK', m)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert [ln for ln in out.stdout.splitlines() if ln.startswith("OK ")] == \
        [f"OK {m}" for m in MODULES]
    assert "--device" in out.stdout


@pytest.mark.parametrize("mod,argv", [
    (tier_accuracy, ["--model", "dpdfnet2"]),
    (bench_sweep, ["--model", "dpdfnet2", "--points", "b1:s8"]),
    (stream_sweep, ["--model", "dpdfnet2", "--points", "exact:s2:high"]),
    (batch_enhance, ["in", "out", "--random-weights", "--model", "dpdfnet2"]),
    (finetune, ["--model", "dpdfnet2", "--steps", "1"]),
    (serving_pool, ["--model", "dpdfnet2"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_tools_default_to_the_card(mod, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_tier_accuracy_json_covers_both_regimes():
    (line,) = _main(tier_accuracy, ["--model", "dpdfnet2", "--seconds", "0.5", "--batch", "1",
                                    "--json", "--device", "cpu"])
    out = json.loads(line)
    assert out["device"] == "cpu" and out["model"] == "dpdfnet2"
    assert set(out["results"]) == {"contractive", "raw"}
    for regime in out["results"].values():
        assert {"high", "fast", "turbo"} <= set(regime)
        for tier in ("high", "fast", "turbo"):
            d = regime[tier]
            assert set(d) == {"rel_rms", "max_abs", "rms_vs_input_db", "stoi_vs_highest",
                              "sisnr_vs_highest_db"}
            assert all(np.isfinite(v) for v in d.values())
        # on the CPU high and fast run float32 like highest; turbo is bfloat16
        assert regime["high"]["max_abs"] == regime["fast"]["max_abs"] == 0.0
        assert 0.0 < regime["turbo"]["rel_rms"] < 0.2


def test_tier_accuracy_table_passes_each_regime_its_weights(monkeypatch):
    calls = []

    def fake(model, **kw):
        calls.append(kw["contract"])
        row = {"rel_rms": 1e-3, "max_abs": 2e-4, "rms_vs_input_db": -60.0,
               "stoi_vs_highest": 0.999, "sisnr_vs_highest_db": 40.0}
        return {"_ref_rms": 0.1, "_input_rms": 0.1, "fast": row, "turbo": row}
    monkeypatch.setattr("dpdfnet_tpu_torch.quality.tier_deviation", fake)
    lines = _main(tier_accuracy, ["--model", "dpdfnet2", "--contract", "0.5",
                                  "--device", "cpu"])
    assert calls == [0.5, None]
    assert lines[0].startswith("model=dpdfnet2 device=cpu")
    rows = [ln.split() for ln in lines[2:]]
    assert [r[:2] for r in rows] == [["fast", "contractive"], ["turbo", "contractive"],
                                     ["fast", "raw"], ["turbo", "raw"]]
    assert all(float(r[2]) == 1e-3 and float(r[3]) == 2e-4 for r in rows)


def test_bench_sweep_prints_one_line_per_point(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "run_bench", _fake(
        bench.run_bench, calls,
        lambda a: {"value": 10.0 * a["batch"] + a["seg_frames"], "device": "cpu"}))
    lines = _main(bench_sweep, ["--model", "dpdfnet2", "--points", "b2:s8", "b1:s16",
                                "--seconds", "0.25", "--reps", "2", "--precision", "turbo",
                                "--device", "cpu"])
    got = [json.loads(ln) for ln in lines]
    assert got == [{"point": "b2:s8", "model": "dpdfnet2", "precision": "turbo", "xrt": 28.0,
                    "device": "cpu"},
                   {"point": "b1:s16", "model": "dpdfnet2", "precision": "turbo", "xrt": 26.0,
                    "device": "cpu"}]
    assert [(c["batch"], c["seg_frames"], c["seconds"], c["reps"], c["device"])
            for c in calls] == [(2, 8, 0.25, 2, "cpu"), (1, 16, 0.25, 2, "cpu")]
    with pytest.raises(ValueError, match="b<batch>"):
        bench_sweep.parse_point("s8")
    with pytest.raises(ValueError, match="unknown token"):
        bench_sweep.parse_point("b2:s8:x")


def test_stream_sweep_points(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "run_stream_bench", _fake(
        bench.run_stream_bench, calls, lambda a: {"metric": "m", "value": 1.5, "device": "cpu"}))
    lines = _main(stream_sweep, ["--model", "dpdfnet2", "--seconds", "0.2", "--device", "cpu",
                                 "--points", "exact:s2:high", "thr:s4:h2:turbo"])
    got = [json.loads(ln) for ln in lines]
    assert [g["point"] for g in got] == ["exact:s2:high", "thr:s4:h2:turbo"]
    assert [(c["mode"], c["streams"], c["hops_per_call"], c["precision"]) for c in calls] == \
        [("exact", 2, 0, "high"), ("throughput", 4, 2, "turbo")]
    assert all(c["seconds"] == 0.2 and c["device"] == "cpu" for c in calls)
    # a point names run_stream_bench's arguments and nothing else
    assert set(stream_sweep.parse_point("thr:s4:h2:turbo")) == {
        "mode", "streams", "hops_per_call", "precision"}


def test_resampler_delta_reports_every_ratio():
    lines = _main(resampler_delta, ["--seconds", "0.25", "--device", "cpu"])
    heads = [ln for ln in lines if not ln.startswith("  ")]
    assert heads == [f"{a} -> {b}:" for a, b in resampler_delta.RATES]
    rows = [ln.strip() for ln in lines if ln.startswith("  ")]
    assert len(rows) == 2 * len(resampler_delta.RATES)
    for row in rows:
        m = re.fullmatch(r"(native|soxr)\s+vs scipy:\s+(-?\d+\.\d) dB", row)
        assert m or row.endswith(")") and "SKIPPED" in row, row
        if m:
            assert float(m.group(2)) < -40.0


def test_batch_enhance_writes_each_file(tmp_path):
    from dpdfnet_tpu_torch.audio_io import read_wav, write_wav
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models.params import init_params
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    cfg = get_config("dpdfnet2")
    rng = np.random.default_rng(9)
    src = tmp_path / "in"
    src.mkdir()
    wavs = {f"u{i}": (0.1 * rng.normal(size=n)).astype(np.float32)
            for i, n in enumerate((4000, 3000, 2500))}
    for k, w in wavs.items():
        write_wav(src / f"{k}.wav", w, cfg.sample_rate)
    (line,) = _main(batch_enhance, [str(src), str(tmp_path / "out"), "--model", "dpdfnet2",
                                    "--random-weights", "--batch-size", "2", "--device", "cpu"])
    assert line.startswith("[OK] 3 files") and line.endswith("on cpu")
    # the example's batches: sorted by length, two to a call, zero-padded
    eng = engine_from_quality(cfg, init_params(cfg, seed=0, device="cpu"), "high", device="cpu")
    for names in (("u2", "u1"), ("u0",)):
        ins = [read_wav(src / f"{k}.wav")[0] for k in names]
        lengths = np.array([len(w) for w in ins])
        batch = np.zeros((len(ins), lengths.max()), np.float32)
        for j, w in enumerate(ins):
            batch[j, :len(w)] = w
        refs = eng.enhance_waveforms(batch, lengths=lengths)
        for k, ref, n in zip(names, refs, lengths):
            got, sr = read_wav(tmp_path / "out" / f"{k}.wav")
            assert sr == cfg.sample_rate and got.shape == wavs[k].shape == (n,)
            write_wav(tmp_path / "ref.wav", ref[:n], cfg.sample_rate)
            assert (tmp_path / "out" / f"{k}.wav").read_bytes() == \
                (tmp_path / "ref.wav").read_bytes()


def test_finetune_prints_a_loss_per_step():
    lines = _main(finetune, ["--model", "dpdfnet2", "--steps", "2", "--batch", "1",
                             "--seconds", "0.12", "--device", "cpu"])
    assert len(lines) == 2
    for i, ln in enumerate(lines):
        m = re.fullmatch(rf"step\s+{i}\s+loss (\S+)", ln)
        assert m and np.isfinite(float(m.group(1))), ln


def test_serving_pool_prints_latency_against_the_budget():
    (line,) = _main(serving_pool, ["--model", "dpdfnet2", "--streams", "2", "--seconds", "0.05",
                                   "--device", "cpu"])
    m = re.fullmatch(r"2 streams on cpu: call latency p50 (\S+) ms p99 (\S+) ms "
                     r"\(budget 10\.0 ms for 1 hops\)", line)
    assert m and 0 < float(m.group(1)) <= float(m.group(2)), line
