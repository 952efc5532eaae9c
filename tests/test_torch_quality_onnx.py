"""The port's reference-ONNX quality gate against the JAX package's:
``quality.enhance_reference_onnx``, ``quality.validate_vs_onnx``, ``eval
--vs-onnx`` and ``tools/validate_quality.py``; and the port's packaging.

No ``onnxruntime`` and no reference ``.onnx`` graph are here, so the
reference's session is a test double of its shape
(``get_modelmeta().custom_metadata_map``, ``get_inputs()``,
``get_outputs()``, ``run()``), seeded into each package's session cache:

- a passthrough session, which returns the spectrum and state it is fed
  (``tests/test_quality.py``); both packages do the same NumPy operations
  on its outputs, so they agree bit for bit, and within 1e-7 where the
  scipy resampler runs (16 kHz input to a 48 kHz graph: float32 rounding);
- a session over the port's flat-state streaming step
  (``export.make_stream_step`` on the CPU, whose ``(spec [1,1,F,2],
  flat_state [1,S]) -> (spec_e, flat_state')`` contract and sidecar are
  the reference graph's), on ``dpdfnet2`` with the JAX package's
  ``init_params`` + ``contract_params`` (seed 3) carried across.  The
  reference pipeline on it reproduces the port's ``Engine`` within 1e-7
  max-abs and 1e-4 rel_rms on all but the last ``win_len`` samples, which
  the pipeline zero-fills (its shift of ``2 * win_len`` on a signal padded
  by one window) and the engine does not (measured 1.3e-9: both run the
  same network in float32; the pipeline's float64 overlap-add against the
  engine's float32 iSTFT).

The gate's three cases of ``tests/test_quality.py`` run through both
packages with the same fakes: the same exit code, printed lines and CSV
(floats within 1e-6, the bound between the two packages' metrics).
"""

import contextlib
import csv
import fnmatch
import functools
import importlib
import io
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from dpdfnet_tpu import api as jax_api
from dpdfnet_tpu import cli as jax_cli
from dpdfnet_tpu import metrics as jax_metrics
from dpdfnet_tpu import quality as jax_quality

from dpdfnet_tpu_torch import api, cli, metrics, native, quality
from dpdfnet_tpu_torch.audio_io import write_wav
from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.export import make_stream_step, stream_meta
from dpdfnet_tpu_torch.ops import _build
from dpdfnet_tpu_torch.quality import speechlike_test_signal
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.tools import validate_quality
from dpdfnet_tpu_torch.utils.serialization import params_from_jax

from torch_testing import jax_params_np

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dpdfnet_tpu_torch"


class _Input:
    def __init__(self, name, shape):
        self.name, self.shape = name, shape


class _Output:
    def __init__(self, name):
        self.name = name


class _Meta:
    def __init__(self, meta):
        self.custom_metadata_map = {k: str(v) for k, v in meta.items()}


class _PassthroughSession:
    """Returns the spectrum and state it is fed; counts the calls and keeps
    the first and the last state fed."""

    def __init__(self, cfg):
        self.meta = stream_meta(cfg)
        self.F = cfg.freq_bins
        self.calls, self.fed = 0, [None, None]

    def get_modelmeta(self):
        return _Meta(self.meta)

    def get_inputs(self):
        return [_Input("spec", [1, 1, self.F, 2]), _Input("state", [self.meta["state_size"]])]

    def get_outputs(self):
        return [_Output("spec_e"), _Output("state_out")]

    def run(self, out_names, feed):
        self.calls += 1
        self.fed = [self.fed[0] if self.calls > 1 else feed["state"].copy(), feed["state"]]
        return [feed["spec"], feed["state"]]


class _StepSession(_PassthroughSession):
    """The reference graph's contract over the port's flat-state step: the
    spectrum in and out at the reference's scale (the step takes it times
    ``wnorm``), the state as ``[S]``."""

    def __init__(self, cfg, step):
        super().__init__(cfg)
        self.step, self.wnorm = step, cfg.wnorm

    def run(self, out_names, feed):
        self.calls += 1
        spec = torch.from_numpy(feed["spec"] * self.wnorm)
        flat = torch.from_numpy(feed["state"]).reshape(1, -1)
        out, st = self.step(spec, flat)
        return [out.numpy() / self.wnorm, st.reshape(-1).numpy()]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("NO_BANNER", "1")


# --------------------------------------------------------------------------- #
# (a) enhance_reference_onnx on a passthrough session, both packages
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("model,sr,atol", [
    ("dpdfnet2", 16000, 0.0),                 # F = 161
    ("dpdfnet2_48khz_hr", 48000, 0.0),        # F = 481
    ("dpdfnet2_48khz_hr", 16000, 1e-7),       # resampled 16 -> 48 -> 16 kHz
])
def test_reference_pipeline_matches_jax_on_a_passthrough_session(monkeypatch, model, sr,
                                                                 atol):
    cfg = get_config(model)
    x = speechlike_test_signal(0.5, sr, seed=1)[0]
    sess = {"torch": _PassthroughSession(cfg), "jax": _PassthroughSession(cfg)}
    monkeypatch.setitem(quality._ONNX_SESSIONS, "g.onnx", sess["torch"])
    monkeypatch.setitem(jax_quality._ONNX_SESSIONS, "g.onnx", sess["jax"])
    ours = quality.enhance_reference_onnx(x, sr, "g.onnx", cfg.sample_rate)
    ref = jax_quality.enhance_reference_onnx(x, sr, "g.onnx", cfg.sample_rate)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape == x.shape
    if atol == 0.0:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)
    hop = cfg.win_len // 2
    n = int(round(x.size * cfg.sample_rate / sr))
    assert sess["torch"].calls == sess["jax"].calls == (n + 2 * cfg.win_len - cfg.win_len) // hop + 1
    for a, b in zip(sess["torch"].fed, sess["jax"].fed):
        np.testing.assert_array_equal(a, b)
    e = cfg.freq_bins if cfg.hr else cfg.nb_erb
    init = np.array(sess["torch"].meta["erb_norm_init"].split(","), np.float32)
    np.testing.assert_array_equal(sess["torch"].fed[0][:e], init)


# --------------------------------------------------------------------------- #
# (b) the pipeline on the port's streaming step against the port's engine
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _dpdfnet2():
    return params_from_jax(jax_params_np("dpdfnet2"), device="cpu")


def test_reference_pipeline_on_the_exported_step_reproduces_the_engine(monkeypatch):
    cfg, params = get_config("dpdfnet2"), _dpdfnet2()
    x = speechlike_test_signal(0.5, cfg.sample_rate, seed=2)[0]
    sess = _StepSession(cfg, make_stream_step(params, cfg, device="cpu"))
    monkeypatch.setitem(quality._ONNX_SESSIONS, "step.onnx", sess)
    got = quality.enhance_reference_onnx(x, cfg.sample_rate, "step.onnx", cfg.sample_rate)
    want = Engine(cfg, params, device="cpu").enhance_waveforms(x)
    tail = cfg.win_len
    assert got.shape == want.shape == x.shape
    assert sess.calls == (x.size + cfg.win_len) // cfg.hop + 1
    d = got[:-tail] - want[:-tail]
    assert float(np.abs(d).max()) <= 1e-7
    assert float(np.sqrt(np.mean(d ** 2) / np.mean(want[:-tail] ** 2))) <= 1e-4
    assert not got[-tail:].any() and want[-tail:].any()


# --------------------------------------------------------------------------- #
# (c) validate_vs_onnx: the JAX gate's three cases through both packages
# --------------------------------------------------------------------------- #

def _corpus(d, n_clips):
    rows = []
    for i in range(n_clips):
        p = d / f"clip{i}.wav"
        write_wav(p, speechlike_test_signal(2.0, 16000, seed=i)[0], 16000)
        rows.append({"noisy_path": p.name, "clean_path": p.name})
    with open(d / "corpus.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["noisy_path", "clean_path"])
        w.writeheader()
        w.writerows(rows)
    return d / "corpus.csv"


def _fake_pesq(case):
    """pass: equal scores; one_sided: clip 0's reference arm fails (its row
    leaves both averages); missing: no PESQ at all."""
    scores = iter({"pass": [3.14] * 4, "one_sided": [2.0, None, 3.0, 3.0],
                   "missing": [None]}[case])

    def wb_pesq(c, x, sr):
        v = next(scores)
        if v is None:
            raise RuntimeError("NoUtterancesError")
        return v
    return wb_pesq


CASES = {"pass": (2, 0), "one_sided": (2, 0), "missing": (1, 1)}   # clips, rc


def _run_gate(pkg, case, d, monkeypatch, run):
    """``run(q)`` under ``case``'s fakes for package ``pkg``: identity
    enhancement for this package's arm, a passthrough reference session,
    the fake PESQ.  Returns rc, printed lines, session calls."""
    q, a, m = {"torch": (quality, api, metrics),
               "jax": (jax_quality, jax_api, jax_metrics)}[pkg]
    sess = _PassthroughSession(get_config("dpdfnet2"))
    with monkeypatch.context() as mp:
        mp.setitem(q._ONNX_SESSIONS, str(d / "fake.onnx"), sess)
        mp.setattr(a, "enhance", lambda audio, sr, **k: np.asarray(audio, np.float32))
        mp.setattr(m, "wb_pesq", _fake_pesq(case))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run(q)
    return rc, buf.getvalue().splitlines(), sess.calls


def _read(p):
    with open(p, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("case", list(CASES))
def test_validate_vs_onnx_matches_jax(tmp_path, monkeypatch, case):
    n_clips, want_rc = CASES[case]
    csv_p = _corpus(tmp_path, n_clips)
    res = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / f"{pkg}.csv"
        res[pkg] = _run_gate(pkg, case, tmp_path, monkeypatch, lambda q: q.validate_vs_onnx(
            str(csv_p), str(tmp_path / "fake.onnx"), model="dpdfnet2", out_csv=str(out)))
        res[pkg] += (_read(out),)
    (rc, lines, calls, rows), (rc_j, lines_j, calls_j, rows_j) = res["torch"], res["jax"]
    assert rc == rc_j == want_rc and lines == lines_j and calls == calls_j > 100 * n_clips
    assert [list(r) for r in rows] == [list(r) for r in rows_j] and len(rows) == n_clips
    for r, rj in zip(rows, rows_j):
        assert r["noisy_path"] == rj["noisy_path"]
        got = np.array([float(r[k]) for k in r if k != "noisy_path"])
        ref = np.array([float(rj[k]) for k in rj if k != "noisy_path"])
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert lines[-1] == "PASS" if want_rc == 0 else lines[-1].startswith("FAIL: PESQ unavailable")


# --------------------------------------------------------------------------- #
# (d) the CLI and the tool
# --------------------------------------------------------------------------- #

def test_cli_eval_vs_onnx_matches_jax(tmp_path, monkeypatch):
    csv_p = _corpus(tmp_path, 2)
    argv = ["eval", str(csv_p), "--vs-onnx", str(tmp_path / "fake.onnx"), "--model",
            "dpdfnet2"]
    rc, lines, _ = _run_gate("torch", "pass", tmp_path, monkeypatch,
                             lambda q: cli.main(argv + ["--device", "cpu"]))
    rc_j, lines_j, _ = _run_gate("jax", "pass", tmp_path, monkeypatch,
                                 lambda q: jax_cli.main(argv))
    assert rc == rc_j == 0 and lines == lines_j and lines[-1] == "PASS"
    assert [ln.split(":")[0] for ln in lines[:3]] == ["pesq", "stoi", "sisnr"]


def test_cli_eval_vs_onnx_without_onnxruntime_exits_2(tmp_path, monkeypatch, capsys):
    csv_p = _corpus(tmp_path, 1)
    monkeypatch.setitem(sys.modules, "onnxruntime", None)     # import raises
    argv = ["eval", str(csv_p), "--vs-onnx", str(tmp_path / "missing.onnx"), "--model",
            "dpdfnet2"]
    for mod, main in ((jax_api, jax_cli.main), (api, cli.main)):
        monkeypatch.setattr(mod, "enhance", lambda audio, sr, **k: audio)
        assert main(argv) == 2
        err = capsys.readouterr().err
        assert "onnxruntime" in err and err.startswith("Error: ")


def test_validate_quality_tool_passes_its_arguments(monkeypatch):
    seen = {}

    def fake(csv_path, onnx_path, **kw):
        seen.update(kw, csv_path=csv_path, onnx_path=onnx_path)
        return 7

    monkeypatch.setattr(quality, "validate_vs_onnx", fake)
    assert validate_quality.main(["c.csv", "--onnx", "m.onnx", "--model", "dpdfnet4",
                                  "--out", "r.csv", "--pesq-tolerance", "0.05",
                                  "--device", "cpu"]) == 7
    assert seen == {"csv_path": "c.csv", "onnx_path": "m.onnx", "model": "dpdfnet4",
                    "out_csv": "r.csv", "pesq_tolerance": 0.05, "device": "cpu"}
    validate_quality.main(["c.csv", "--onnx", "m.onnx"])
    assert seen["model"] == "dpdfnet8_48khz_hr" and seen["device"] is None
    assert seen["pesq_tolerance"] == 0.01 and seen["out_csv"] is None


# --------------------------------------------------------------------------- #
# (e) the port's sources live in the package, and the package carries them
# --------------------------------------------------------------------------- #

def test_sources_resolve_inside_the_package_and_ship_with_it():
    sources = [native.SOURCE] + [_build.CSRC / f for main, headers in _build.SOURCES.values()
                                 for f in (main, *headers)]
    for src in sources:
        assert src.resolve().is_relative_to(PKG) and src.is_file(), src
    # the port's copy of the host library is the JAX package's source
    assert native.SOURCE.read_bytes() == (ROOT / "native" / "dpdfnet_host.cpp").read_bytes()
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = project["tool"]["setuptools"]["package-data"]["dpdfnet_tpu_torch"]
    shipped = [p.relative_to(PKG).as_posix()
               for p in sorted((PKG / "csrc").iterdir()) + sorted((PKG / "tools").glob("*.json"))]
    assert len(shipped) > len(_build.SOURCES)
    for rel in shipped:
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    mod, func = project["project"]["scripts"]["dpdfnet-tpu-torch"].split(":")
    assert getattr(importlib.import_module(mod), func) is cli.main
