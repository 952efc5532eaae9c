"""The port's host-side remainder against the JAX package's: the native
host library (``native.py``) and its callers, the build directory
(``utils/compile_cache.py``) and the perceptual columns of
``quality.tier_deviation``.

The port builds its own copy of the host source,
``dpdfnet_tpu_torch/csrc/dpdfnet_host.cpp`` (``g++``, into its build
directory); the JAX package builds ``native/dpdfnet_host.cpp``, the same
bytes, with its Makefile.  Both libraries run the same C++ on the same inputs, so the
outputs are compared bit for bit; the NumPy forms they replace are held
to the same bits (overlap-add, WAV bytes and samples), the resampler to
scipy's ``resample_poly`` within 1e-3 (the JAX test's bound).  The
``tier_deviation`` columns against JAX's: ``fast`` within 1e-6 in STOI
(the two packages' metrics agree to 1e-6, ``test_torch_cli.py``) and
1e-4 dB in SI-SNR (on the CPU ``fast`` is ``highest`` in both packages,
and on these contracted weights the two ``highest`` outputs have the
same RMS; measured 1.7e-7 and 8e-7 dB apart); ``turbo`` within 1e-4 in
STOI and 0.1 dB in SI-SNR (each package's bf16 rounding against its own
``highest``, the two within the tier bound of rel_rms 3e-3; measured
1.2e-6 and 1.8e-3 dB apart).
"""

import functools
import shutil

import numpy as np
import pytest
import jax
import torch

from dpdfnet_tpu import native as jax_native
from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import params as jax_params
from dpdfnet_tpu.quality import tier_deviation as jax_tier_deviation

from dpdfnet_tpu_torch import audio, audio_io, native, stream
from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.ops import _build
from dpdfnet_tpu_torch.quality import speechlike_test_signal, tier_deviation
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.utils import compile_cache
from dpdfnet_tpu_torch.utils.serialization import params_from_jax

torch.set_num_threads(1)

PAIRS = [(3, 1), (1, 3), (160, 441), (441, 160)]


@pytest.fixture(scope="module")
def libs():
    """Both packages' libraries, loaded afresh."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    for mod in (native, jax_native):
        mod._TRIED, mod._LIB = False, None
    assert native.available(), "the port's native library did not build"
    assert jax_native.available(), "the JAX package's native library did not build"
    return native, jax_native


def _tone(n=16000, sr=16000):
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1330 * t)
            ).astype(np.float32)


def test_library_builds_into_the_build_directory(libs):
    path = native.lib_path()
    assert path.parent == compile_cache.build_dir() and path.is_file()
    assert path.name.startswith("libdpdfnet_host-") and native.build() == path


@pytest.mark.parametrize("up,down", PAIRS)
def test_resample_matches_jax_and_scipy(libs, up, down):
    from scipy.signal import resample_poly

    x = _tone()
    y = native.resample(x, up, down)
    assert np.array_equal(y, jax_native.resample(x, up, down))
    ref = resample_poly(x.astype(np.float64), up, down).astype(np.float32)
    n = min(len(y), len(ref))
    assert abs(len(y) - len(ref)) <= 1
    np.testing.assert_allclose(y[200:n - 200], ref[200:n - 200], atol=1e-3)


def test_resampler_backend_native(libs, monkeypatch):
    x = _tone(4800, 48000)
    monkeypatch.setenv("DPDFNET_TPU_RESAMPLER", "native")
    assert np.array_equal(audio.resample(x, 48000, 16000), native.resample(x, 1, 3))
    # multi-channel input takes scipy along the sample axis
    st = np.stack([x, -x], axis=-1)
    assert audio.resample(st, 48000, 16000).shape == (1600, 2)


def test_ola_commit_matches_jax_and_numpy(libs):
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(7, 320)).astype(np.float32)
    tail0 = rng.normal(size=160).astype(np.float32)
    t_port, t_jax = tail0.copy(), tail0.copy()
    got = native.ola_commit(frames, t_port)
    assert np.array_equal(got, jax_native.ola_commit(frames, t_jax))
    assert np.array_equal(t_port, t_jax)
    tails = np.concatenate([tail0[None], frames[:-1, 160:]], axis=0)
    assert np.array_equal(got, (frames[:, :160] + tails).reshape(-1))
    assert np.array_equal(t_port, frames[-1, 160:])
    with pytest.raises(ValueError, match="tail"):
        native.ola_commit(frames, np.zeros(160, np.float64))


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_io_matches_jax_and_numpy(libs, tmp_path, monkeypatch, channels):
    """The native writer writes the NumPy writer's bytes and the JAX
    library's; both readers read them back as the same samples."""
    rng = np.random.default_rng(channels)
    x = np.clip(0.5 * rng.normal(size=(4800, channels)), -1, 1).astype(np.float32)
    x = x[:, 0] if channels == 1 else x
    ours, theirs, plain = tmp_path / "o.wav", tmp_path / "t.wav", tmp_path / "p.wav"
    assert native.wav_write(ours, x, 48000) and jax_native.wav_write(theirs, x, 48000)
    audio_io.write_wav(tmp_path / "a.wav", x, 48000)          # through the native writer
    with monkeypatch.context() as m:
        m.setattr(native, "load", lambda: None)
        audio_io.write_wav(plain, x, 48000)
        y_plain, _ = audio_io.read_wav(ours)
    assert ours.read_bytes() == theirs.read_bytes() == plain.read_bytes() \
        == (tmp_path / "a.wav").read_bytes()
    y, sr = native.wav_read(ours)
    y_jax, _ = jax_native.wav_read(ours)
    assert sr == 48000 and np.array_equal(y, y_jax) and np.array_equal(y, y_plain)
    assert np.array_equal(audio_io.read_wav(ours)[0], y)
    # float32 files too; anything else falls back to NumPy
    audio_io.write_wav(tmp_path / "f.wav", x, 16000, subtype="FLOAT")
    assert np.array_equal(native.wav_read(tmp_path / "f.wav")[0], x)
    assert np.array_equal(audio_io.read_wav(tmp_path / "f.wav")[0], x)


def test_stream_enhancer_native_ola_is_bit_identical(libs, monkeypatch):
    cfg = get_config("dpdfnet2")
    p = jax_params.contract_params(jax_params.init_params(jax_get_config("dpdfnet2"), seed=3))
    eng = Engine(cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu"),
                 device="cpu")
    x = speechlike_test_signal(0.2, cfg.sample_rate, seed=4)[0]
    chunks = np.split(x, [333, 1500, 1501])
    outs = []
    for off in (False, True):
        with monkeypatch.context() as m:
            if off:
                m.setattr(native, "load", lambda: None)
            s = stream.StreamEnhancer(engine=eng)
            outs.append(np.concatenate([s.process(c) for c in chunks] + [s.flush()]))
    assert outs[0].size > 0 and np.array_equal(outs[0], outs[1])


def test_native_switches(monkeypatch, tmp_path, libs):
    """``DPDFNET_TPU_NATIVE=0`` turns the library off;
    ``DPDFNET_TPU_NATIVE_LIB`` names the library to load; a library that
    cannot be loaded gives ``None``."""
    built = native.lib_path()
    for env, want in ((("DPDFNET_TPU_NATIVE", "0"), False),
                      (("DPDFNET_TPU_NATIVE_LIB", str(built)), True),
                      (("DPDFNET_TPU_NATIVE_LIB", str(tmp_path / "missing.so")), False)):
        monkeypatch.setattr(native, "_TRIED", False)
        monkeypatch.setattr(native, "_LIB", None)
        with monkeypatch.context() as m:
            m.setenv(*env)
            assert native.available() is want
            assert (native.resample(_tone(300), 1, 3) is None) is not want
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available()


def test_compile_cache_sets_the_build_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "_dir", None)
    for flag in (None, "0"):
        with monkeypatch.context() as m:
            if flag is None:
                m.delenv("DPDFNET_TPU_COMPILE_CACHE", raising=False)
            else:
                m.setenv("DPDFNET_TPU_COMPILE_CACHE", flag)
            assert compile_cache.enable() == compile_cache.DEFAULT_DIR
    assert compile_cache.DEFAULT_DIR.name == "_build"
    assert compile_cache.DEFAULT_DIR.parent.name == "dpdfnet_tpu_torch"
    monkeypatch.setenv("DPDFNET_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.enable() == tmp_path / "env" == compile_cache.build_dir()
    assert _build._lib_path("gru_scan").parent == tmp_path / "env"
    assert native.lib_path().parent == tmp_path / "env"
    assert compile_cache.enable(tmp_path / "arg") == tmp_path / "arg"
    assert _build._lib_path("relayout_fm").parent == tmp_path / "arg"


def test_native_library_builds_where_compile_cache_points(monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(compile_cache, "_dir", tmp_path / "cache")
    path = native.build()
    assert path == native.lib_path() and path.parent == tmp_path / "cache" and path.is_file()


@functools.lru_cache(maxsize=None)
def _tier_deviations():
    kw = dict(seconds=0.4, batch=1, seed=0, contract=0.7, tiers=("fast", "turbo"))
    ref = jax_tier_deviation("dpdfnet2", **kw)
    p = jax.tree_util.tree_map(np.asarray,
                               jax_params.init_params(jax_get_config("dpdfnet2"), seed=0))
    got = tier_deviation("dpdfnet2", params=params_from_jax(p, device="cpu"), device="cpu",
                         **kw)
    return got, ref


@pytest.mark.parametrize("tier,stoi_tol,sisnr_tol", [("fast", 1e-6, 1e-4),
                                                     ("turbo", 1e-4, 0.1)])
def test_tier_deviation_perceptual_columns_match_jax(tier, stoi_tol, sisnr_tol):
    got, ref = _tier_deviations()
    assert set(got[tier]) == set(ref[tier])
    assert abs(got[tier]["stoi_vs_highest"] - ref[tier]["stoi_vs_highest"]) <= stoi_tol
    assert abs(got[tier]["sisnr_vs_highest_db"] - ref[tier]["sisnr_vs_highest_db"]) <= sisnr_tol
    assert 0.9 < got[tier]["stoi_vs_highest"] <= 1.0 + 1e-9
