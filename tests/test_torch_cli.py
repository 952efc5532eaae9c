"""The port's command line, bench runner, audio file I/O, metrics and demo
against the JAX package's.

Weights: random contracted weights for ``dpdfnet2`` saved once with the
JAX ``save_params`` into a temporary ``DPDFNET_TPU_MODEL_DIR``; each
package loads that npz with its own loader.  The port runs with
``--device cpu`` / ``device="cpu"``, the JAX package on the CPU.

Tolerances: the CLI's 16-bit output wav within one 16-bit step of the
JAX CLI's (the waveforms agree to 1e-4 before quantisation, and a value
near a rounding boundary may land one step apart); the file-mode demo
within 1e-4 (the streaming bound of ``test_torch_stream.py``); wav bytes
and the reader's samples equal; the metrics within 1e-6 (the same NumPy
and SciPy calls); the terminal spectrogram's lines equal.
"""

import io
import json
import struct
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dpdfnet_tpu import api as jax_api
from dpdfnet_tpu import audio_io as jax_audio_io
from dpdfnet_tpu import cli as jax_cli
from dpdfnet_tpu import demo as jax_demo
from dpdfnet_tpu import metrics as jax_metrics
from dpdfnet_tpu import termviz as jax_termviz
from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.runtime.engine import Engine as JaxEngine
from dpdfnet_tpu.stream import StreamEnhancer as JaxStreamEnhancer
from dpdfnet_tpu.utils.serialization import save_params

from dpdfnet_tpu_torch import api, audio_io, cli, demo, metrics, termviz, zoo
from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models.params import contract_params, init_params
from dpdfnet_tpu_torch.runtime import bench
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.stream import StreamEnhancer
from dpdfnet_tpu_torch.utils.serialization import load_params
from dpdfnet_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)
MODEL = "dpdfnet2"
SR = 16000
STEP = 1.0 / 32768.0          # one 16-bit step as read_wav scales it


def _clear_caches():
    api.clear_engine_cache()
    jax_api._ENGINE_CACHE.clear()
    jax_api._ENGINE_BUILD_LOCKS.clear()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory holding dpdfnet2's npz (random contracted weights,
    the port's ``init_params``), written by the JAX package's
    ``save_params``."""
    d = tmp_path_factory.mktemp("models")
    p = contract_params(init_params(get_config(MODEL), seed=3, device="cpu"))
    save_params(d / f"{MODEL}.params.npz", tree_map(lambda _, x: x.numpy(), p))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPDFNET_TPU_MODEL_DIR", str(d))
        mp.setenv("DPDFNET_TPU_CACHE_DIR", str(d / "cache"))
        mp.setenv("NO_BANNER", "1")
        _clear_caches()
        yield d
        _clear_caches()


@pytest.fixture
def tmp_model_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DPDFNET_TPU_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("DPDFNET_TPU_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path


def _speech(seed, seconds, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=t.shape[0])
            ).astype(np.float32)


def _within_one_step(a_path, b_path):
    a, sra = audio_io.read_wav(a_path)
    b, srb = audio_io.read_wav(b_path)
    assert sra == srb and a.shape == b.shape
    assert np.abs(a - b).max() <= STEP * 1.0001


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #

def test_cli_models_table_matches_jax(tmp_model_dir, capsys):
    assert jax_cli.main(["models"]) == 0
    ref = capsys.readouterr().out
    assert cli.main(["models"]) == 0
    out = capsys.readouterr().out
    assert out == ref
    for name in zoo.supported_models():
        assert name in out


@pytest.mark.parametrize("extra", [[], ["--attn-limit-db", "12"]])
def test_cli_enhance_matches_jax_cli(model_dir, tmp_path, capsys, extra):
    src = tmp_path / "noisy.wav"
    audio_io.write_wav(src, _speech(1, 1.0), SR)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    assert cli.main(["enhance", str(src), str(ours), "--model", MODEL,
                     "--device", "cpu", *extra]) == 0
    assert "Wrote enhanced audio" in capsys.readouterr().out
    assert jax_cli.main(["enhance", str(src), str(theirs), "--model", MODEL, *extra]) == 0
    _within_one_step(ours, theirs)
    # the same file through the API, with the default output name
    out = api.enhance_file(src, model=MODEL, device="cpu",
                           attn_limit_db=12.0 if extra else None)
    assert out == src.with_name("noisy_enhanced.wav")
    assert out.read_bytes() == ours.read_bytes()


def test_cli_enhance_dir_matches_jax_cli(model_dir, tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    audio_io.write_wav(src / "a.wav", _speech(2, 1.0), SR)
    audio_io.write_wav(src / "b.wav", _speech(3, 0.7), SR)
    audio_io.write_wav(src / "c.wav", _speech(4, 1.0, 8000), 8000)
    audio_io.write_wav(src / "a.wave", _speech(5, 0.5), SR)     # same stem as a.wav
    (src / "notes.txt").write_text("not audio")
    assert cli.main(["enhance-dir", str(src), str(tmp_path / "ours"), "--model", MODEL,
                     "--device", "cpu", "--workers", "3"]) == 0
    assert jax_cli.main(["enhance-dir", str(src), str(tmp_path / "theirs"),
                         "--model", MODEL, "--workers", "3"]) == 0
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert names == ["a_wav_enhanced.wav", "a_wave_enhanced.wav", "b_enhanced.wav",
                     "c_enhanced.wav"]
    for n in names:
        _within_one_step(tmp_path / "ours" / n, tmp_path / "theirs" / n)


def test_cli_download_with_fake_fetch(tmp_model_dir, monkeypatch, capsys):
    def fake_download(url, destination):
        Path(destination).parent.mkdir(parents=True, exist_ok=True)
        Path(destination).write_bytes(b"fake checkpoint")

    monkeypatch.setattr(zoo, "_download_one", fake_download)
    assert cli.main(["download", "dpdfnet2"]) == 0
    out = capsys.readouterr().out
    assert "Downloaded 'dpdfnet2'" in out
    assert (tmp_model_dir / "models" / "dpdfnet2.pth").read_bytes() == b"fake checkpoint"
    assert cli.main(["download", "-q"]) == 0
    assert out.count("\n") == 1 and "- baseline:" in capsys.readouterr().out
    # the cached checkpoint is now listed as ready (no converted params yet)
    rows = {r["name"]: r for r in api.available_models()}
    assert rows["dpdfnet2"]["ready"] and rows["dpdfnet2"]["params_path"] is None


@pytest.mark.parametrize("argv,err", [
    (["enhance", "{tmp}/nope.wav", "{tmp}/out.wav", "--device", "cpu"], "Input file not found"),
    (["enhance-dir", "{tmp}/empty", "{tmp}/o", "--device", "cpu"], "No supported audio"),
    (["enhance-dir", "{tmp}/missing", "{tmp}/o", "--device", "cpu"], "not found"),
    (["download", "dpdfnet2", "--model", "dpdfnet4"], "Conflicting"),
    (["eval", "{tmp}/x.csv", "--vs-onnx", "{tmp}/m.onnx"], "onnxruntime"),
    (["eval", "{tmp}/missing.csv"], "metadata CSV not found"),
])
def test_cli_errors_exit_2(tmp_model_dir, capsys, argv, err):
    (tmp_model_dir / "empty").mkdir()
    argv = [a.format(tmp=tmp_model_dir) for a in argv]
    assert cli.main(argv) == 2
    assert err in capsys.readouterr().err


def test_cli_no_command_prints_help_and_version(capsys):
    assert cli.main([]) == 0
    assert "usage" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli.main(["--version"])
    assert e.value.code == 0
    assert "dpdfnet_tpu_torch 0.1.0" in capsys.readouterr().out


def test_cli_forwards_flags_to_the_api(monkeypatch, tmp_path):
    seen = {}

    def fake_enhance_file(**kwargs):
        seen.update(kwargs)
        return tmp_path / "out.wav"

    monkeypatch.setattr(api, "enhance_file", fake_enhance_file)
    assert cli.main(["enhance", "in.wav", "out.wav", "--attn-limit-db", "12",
                     "--quality", "turbo", "--model", "dpdfnet8_48khz_hr"]) == 0
    assert seen["attn_limit_db"] == 12.0 and seen["quality"] == "turbo"
    assert seen["model"] == "dpdfnet8_48khz_hr" and seen["device"] == "cuda"


# --------------------------------------------------------------------------- #
# Bench runner
# --------------------------------------------------------------------------- #

def test_bench_vs_baseline_is_a_card_figure():
    assert bench.CARD_BASELINE_XRT == 362.4


@pytest.mark.parametrize("precision,label", [("turbo", "turbo"), ("default", "default"),
                                             ("high", "high")])
def test_run_bench_keys_and_metric_name(precision, label):
    out = json.loads(bench.run_bench(model="baseline", batch=2, seconds=0.3, reps=1,
                                     precision=precision, device="cpu"))
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert out["metric"] == f"xRT_per_chip_baseline_offline_b2_{label}"
    assert out["unit"] == "x_realtime" and out["device"] == "cpu"
    assert out["value"] > 0
    # against the card figure (the value is rounded to 0.01, the ratio to 1e-4)
    assert out["vs_baseline"] == pytest.approx(out["value"] / 362.4, abs=1e-4)


@pytest.mark.parametrize("mode,hops", [("exact", 0), ("exact", 2), ("throughput", 2)])
def test_run_stream_bench_keys_and_metric_name(mode, hops):
    out = json.loads(bench.run_stream_bench(model="baseline", streams=2, seconds=0.2,
                                            precision="fast", mode=mode,
                                            hops_per_call=hops, device="cpu"))
    tag = f"_h{hops}" if hops else ""
    assert out["metric"] == f"stream_hop_device_ms_baseline_s2{tag}_{mode}_fast"
    assert out["unit"] == "ms_per_hop" and out["device"] == "cpu"
    assert np.isfinite(out["value"]) and out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(10.0 / out["value"], rel=1e-3, abs=2e-3)
    assert out["realtime_stream_capacity_est"] >= 0
    if hops:
        assert out["hops_per_call"] == 2
        assert out["buffering_latency_ms"] == pytest.approx(20.0)


def test_run_serving_bench_keys_and_metric_name():
    out = json.loads(bench.run_serving_bench(model="baseline", streams=2, hops_per_call=2,
                                             calls=2, precision="high", device="cpu"))
    assert out["metric"] == "serving_wall_ms_per_hop_baseline_s2_h2_exact_high"
    assert out["unit"] == "ms_per_hop_wall" and out["device"] == "cpu"
    assert out["per_call_ms"] == pytest.approx(2 * out["value"], rel=1e-2)
    assert {"added_latency_ms", "realtime_stream_capacity_est", "vs_baseline"} <= set(out)


def test_cli_bench_prints_the_line_and_a_trace(tmp_path, capsys):
    assert cli.main(["bench", "--device", "cpu", "--model", "baseline", "--batch", "2",
                     "--seconds", "0.3", "--reps", "1", "--random-weights",
                     "--precision", "high", "--profile", str(tmp_path / "prof")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "xRT_per_chip_baseline_offline_b2_high"
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert cli.main(["bench", "--device", "cpu", "--model", "baseline", "--streaming",
                     "--streams", "2", "--precision", "high", "--hops-per-call", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "stream_hop_device_ms_baseline_s2_h4_exact_high"


# --------------------------------------------------------------------------- #
# Audio file I/O
# --------------------------------------------------------------------------- #

_RNG = np.random.default_rng(8)
_MONO = np.clip(0.5 * _RNG.normal(size=4801), -1.2, 1.2).astype(np.float32)
_STEREO = np.clip(0.5 * _RNG.normal(size=(1601, 2)), -1, 1).astype(np.float32)


@pytest.mark.parametrize("subtype,data", [
    ("PCM_16", "mono"), ("PCM_16", "stereo"), ("PCM_16", "int16"),
    ("FLOAT", "mono"), ("FLOAT", "stereo"),
])
def test_write_wav_bytes_equal_jax(tmp_path, subtype, data):
    x = {"mono": _MONO, "stereo": _STEREO,
         "int16": (_MONO * 20000).astype(np.int16)}[data]
    ours, theirs = tmp_path / "a.wav", tmp_path / "b.wav"
    audio_io.write_wav(ours, x, 48000, subtype=subtype)
    jax_audio_io.write_wav(theirs, x, 48000, subtype=subtype)
    assert ours.read_bytes() == theirs.read_bytes()
    for reader in (audio_io.read_wav, jax_audio_io.read_wav):
        y, sr = reader(ours)
        assert sr == 48000 and y.shape == x.shape
    np.testing.assert_array_equal(audio_io.read_wav(theirs)[0], jax_audio_io.read_wav(ours)[0])


def _wav_bytes(payload, fmt_tag, channels, sr, bits, extensible=False):
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_tag, channels, sr,
                      sr * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_tag) + b"\0" * 14
    odd = b"LIST" + struct.pack("<I", 3) + b"abc\0"              # an odd chunk, padded
    return b"".join([b"RIFF", struct.pack("<I", 4 + len(odd) + 8 + len(fmt) + 8 + len(payload)),
                     b"WAVE", odd, b"fmt ", struct.pack("<I", len(fmt)), fmt,
                     b"data", struct.pack("<I", len(payload)), payload])


@pytest.mark.parametrize("kind", ["pcm8", "pcm16", "pcm24", "pcm32", "f32", "f64",
                                  "extensible_pcm16", "stereo_pcm24"])
def test_read_wav_agrees_with_jax(tmp_path, kind):
    rng = np.random.default_rng(9)
    n, ch = 777, 2 if kind.startswith("stereo") else 1
    if kind == "pcm8":
        raw, tag, bits = rng.integers(0, 256, n, dtype=np.uint8).tobytes(), 1, 8
    elif kind in ("pcm16", "extensible_pcm16"):
        raw, tag, bits = rng.integers(-32768, 32768, n).astype("<i2").tobytes(), 1, 16
    elif kind.endswith("pcm24"):
        ints = rng.integers(-(1 << 23), 1 << 23, n * ch).astype("<i4")
        raw = b"".join(int(v).to_bytes(3, "little", signed=True) for v in ints)
        tag, bits = 1, 24
    elif kind == "pcm32":
        raw, tag, bits = rng.integers(-(1 << 31), 1 << 31, n).astype("<i4").tobytes(), 1, 32
    elif kind == "f32":
        raw, tag, bits = rng.normal(size=n).astype("<f4").tobytes(), 3, 32
    else:
        raw, tag, bits = rng.normal(size=n).astype("<f8").tobytes(), 3, 64
    p = tmp_path / "x.wav"
    p.write_bytes(_wav_bytes(raw, tag, ch, 22050, bits, extensible=kind.startswith("ext")))
    got, sr = audio_io.read_wav(p)
    ref, sr_ref = jax_audio_io.read_wav(p)
    assert sr == sr_ref == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("payload,err", [
    (b"not a wav at all", "Not a RIFF/WAVE"),
    (b"RIFF\x10\0\0\0WAVEdata\xff\0\0\0ab", "Truncated"),
    (b"RIFF\x0c\0\0\0WAVEfmt \x04\0\0\0abcd", "Malformed"),
])
def test_read_wav_rejects_like_jax(tmp_path, payload, err):
    p = tmp_path / "bad.wav"
    p.write_bytes(payload)
    with pytest.raises(ValueError, match=err):
        audio_io.read_wav(p)


def test_read_audio_routes_like_jax(tmp_path, monkeypatch):
    assert audio_io.SUPPORTED_EXTENSIONS == jax_audio_io.SUPPORTED_EXTENSIONS
    p = tmp_path / "x.xyz"
    p.write_bytes(b"\xff\xfb")
    with pytest.raises(ValueError, match="Unsupported audio format"):
        audio_io.read_audio(p)

    class FakeSegment:
        frame_rate, sample_width, channels = 22050, 2, 2

        @staticmethod
        def from_file(path):
            return FakeSegment()

        def get_array_of_samples(self):
            return [0, 16384, -32768, 32767]

    fake = types.ModuleType("pydub")
    fake.AudioSegment = FakeSegment
    monkeypatch.setitem(sys.modules, "pydub", fake)
    mp3 = tmp_path / "x.mp3"
    mp3.write_bytes(b"\0")
    y, sr = audio_io.read_audio(mp3)
    ref, _ = jax_audio_io.read_audio(mp3)
    assert sr == 22050 and y.shape == (2, 2)
    np.testing.assert_array_equal(y, ref)
    for layout in ("mono", "stereo", "5.1", "5.1(side)", "7.1", "quad", "6 channels",
                   "nonsense"):
        assert audio_io._ffmpeg_layout_channels(layout) == \
            jax_audio_io._ffmpeg_layout_channels(layout)


# --------------------------------------------------------------------------- #
# Metrics
# --------------------------------------------------------------------------- #

def _pair(seed, n=SR):
    rng = np.random.default_rng(seed)
    clean = _speech(seed, n / SR)
    return clean, (clean + 0.1 * rng.normal(size=n)).astype(np.float32)


def test_si_snr_and_alignment_equal_jax():
    clean, noisy = _pair(10)
    assert metrics.si_snr(clean, noisy) == pytest.approx(jax_metrics.si_snr(clean, noisy),
                                                         abs=1e-6)
    for lag in (0, 37, -120):
        a = np.roll(noisy, lag)[max(lag, 0): len(noisy) + min(lag, 0)]
        got = metrics.align_by_xcorr_trim(a, clean)
        ref = jax_metrics.align_by_xcorr_trim(a, clean)
        assert got[2] == ref[2]
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-6)


@pytest.mark.parametrize("sr", [10000, 16000])
def test_stoi_equals_jax(sr):
    clean, noisy = _pair(11, 2 * sr)
    got = metrics.stoi(clean, noisy, sr)
    assert 0.0 < got <= 1.0
    assert got == pytest.approx(jax_metrics.stoi(clean, noisy, sr), abs=1e-6)
    with pytest.raises(ImportError, match="pesq"):
        metrics.wb_pesq(clean, noisy, sr)


def test_evaluate_csv_equals_jax(tmp_path):
    pytest.importorskip("pandas")
    clean, noisy = _pair(12)
    audio_io.write_wav(tmp_path / "c.wav", clean, SR)
    audio_io.write_wav(tmp_path / "e.wav", noisy, SR)
    (tmp_path / "meta.csv").write_text("enhanced_path,clean_path\ne.wav,c.wav\n"
                                       "missing.wav,c.wav\n")
    ours = metrics.evaluate_csv(str(tmp_path / "meta.csv"), "ours.csv")
    theirs = jax_metrics.evaluate_csv(str(tmp_path / "meta.csv"), "theirs.csv")
    assert Path(ours).read_text() == Path(theirs).read_text()
    assert metrics.main([str(tmp_path / "meta.csv")]) == 0


# --------------------------------------------------------------------------- #
# Demo and terminal spectrogram
# --------------------------------------------------------------------------- #

def test_demo_file_mode_matches_jax(model_dir, tmp_path, capsys):
    src = tmp_path / "in.wav"
    audio_io.write_wav(src, _speech(13, 1.0), SR)
    npz = model_dir / f"{MODEL}.params.npz"
    eng = Engine(get_config(MODEL), load_params(npz, device="cpu"), precision="highest",
                 device="cpu")
    jeng = JaxEngine(jax_get_config(MODEL), jax_api.load_model_params(
        jax_api.resolve_model(model=MODEL, auto_download=False)), precision="highest")
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    assert demo._run_file(StreamEnhancer(engine=eng), SR, 160, 0.8, src, ours, 0.5) == 0
    assert "RTF" in capsys.readouterr().out
    assert jax_demo._run_file(JaxStreamEnhancer(engine=jeng), SR, 160, 0.8, src, theirs,
                              0.5) == 0
    a, _ = audio_io.read_wav(ours)
    b, _ = audio_io.read_wav(theirs)
    assert a.shape == b.shape == (8000,)
    np.testing.assert_allclose(a, b, atol=1e-4)
    # by model name through the CLI (file mode, with the spectrogram)
    short = tmp_path / "short.wav"
    audio_io.write_wav(short, _speech(14, 0.3), SR)
    assert cli.main(["demo", "--input", str(short), "--output", str(tmp_path / "cli.wav"),
                     "--model", MODEL, "--device", "cpu", "--spectrogram"]) == 0
    assert audio_io.read_wav(tmp_path / "cli.wav")[0].shape == (int(0.3 * SR),)
    assert "enhanced" in capsys.readouterr().err


def test_demo_live_mode_without_sounddevice(model_dir, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    se = StreamEnhancer(model=MODEL, device="cpu")
    assert demo._run_live(se, SR, 160, 1.0) == 2
    assert "sounddevice" in capsys.readouterr().err


def test_termviz_lines_equal_jax():
    assert np.array_equal(termviz._band_edges(257, 36), jax_termviz._band_edges(257, 36))
    rng = np.random.default_rng(0)
    noisy = (0.1 * rng.normal(size=3000)).astype(np.float32)
    bufs = []
    for mod in (termviz, jax_termviz):
        buf = io.StringIO()
        viz = mod.TerminalSpectrogram(16000, bands=36, n_fft=512, hop=384, out=buf)
        assert viz.feed(noisy[:1000], 0.3 * noisy[:1000]) == 2
        assert viz.feed(noisy[1000:], 0.3 * noisy[1000:]) == 5
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    lines = bufs[0].splitlines()
    assert "noisy" in lines[0] and all(ln.count("\x1b[48;5;") == 72 for ln in lines[1:])
