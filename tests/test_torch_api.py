"""The port's user-facing API against the JAX package's: ``enhance`` /
``enhance_batch`` by model name from one npz, the segment-stepped offline
path, the model zoo (downloads faked), streams built by name, and the
audio helpers.

Weights: random contracted weights for ``dpdfnet2`` (``init_params`` +
``contract_params``), saved once with the JAX ``save_params`` into a
temporary ``DPDFNET_TPU_MODEL_DIR``; each package loads that npz with its
own loader.  The port runs on ``device="cpu"`` (every kernel wrapper takes
its plain version), the JAX package on the CPU.  Both engine caches are
cleared around the module.

Tolerance: 1e-4 max-abs on the waveform against JAX, the ``Engine``
bound of ``test_torch_engine.py``; bit equality where the port is
compared with itself (stepped against unstepped, streams by name against
``engine=``) and for the host helpers, which compute the same NumPy
operations.
"""

import copy
import os
from pathlib import Path
from urllib.error import HTTPError, URLError

import numpy as np
import pytest
import torch

from dpdfnet_tpu import api as jax_api
from dpdfnet_tpu import audio as jax_audio
from dpdfnet_tpu import zoo as jax_zoo
from dpdfnet_tpu.utils.serialization import save_params

from dpdfnet_tpu_torch import MultiStreamEnhancer, StreamEnhancer, api, audio, zoo
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.utils.serialization import load_params

from torch_testing import port_params_np

ATOL = 1e-4
MODEL = "dpdfnet2"
SR = 16000


def _clear_caches():
    api.clear_engine_cache()
    jax_api._ENGINE_CACHE.clear()
    jax_api._ENGINE_BUILD_LOCKS.clear()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory holding dpdfnet2's npz, written by the JAX
    package's ``save_params``."""
    d = tmp_path_factory.mktemp("models")
    save_params(d / f"{MODEL}.params.npz", port_params_np(MODEL))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPDFNET_TPU_MODEL_DIR", str(d))
        mp.setenv("DPDFNET_TPU_CACHE_DIR", str(d / "cache"))
        _clear_caches()
        yield d
        _clear_caches()


def _speech(seed, seconds, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=t.shape[0])
            ).astype(np.float32)


# --------------------------------------------------------------------------- #
# enhance / enhance_batch against the JAX package
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["16k", "attn_limit", "resample_8k", "stereo"])
def test_enhance_matches_jax(model_dir, case):
    x, sr, kw = _speech(1, 1.0), SR, {}
    if case == "attn_limit":
        kw = {"attn_limit_db": 12.0}
    elif case == "resample_8k":
        x, sr = _speech(2, 1.0, 8000), 8000
    elif case == "stereo":
        x = np.stack([x, _speech(3, 1.0)], axis=-1)
    got = api.enhance(x, sr, model=MODEL, device="cpu", **kw)
    ref = jax_api.enhance(x, sr, model=MODEL, **kw)
    assert got.shape == ref.shape == (x.shape[0],) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_enhance_batch_matches_jax(model_dir):
    xs = [_speech(4, 1.0), _speech(5, 0.6), _speech(6, 1.2, 8000)]
    srs = [SR, SR, 8000]
    got = api.enhance_batch(xs, srs, model=MODEL, device="cpu")
    ref = jax_api.enhance_batch(xs, srs, model=MODEL)
    assert [g.shape for g in got] == [x.shape for x in xs]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL)
    assert api.enhance_batch([], SR, model=MODEL, device="cpu") == []
    with pytest.raises(ValueError, match="sample_rates"):
        api.enhance_batch(xs, [SR], model=MODEL, device="cpu")
    with pytest.raises(TypeError):
        api.enhance_batch(xs, True, model=MODEL, device="cpu")


def test_engine_cache_key_holds_device_and_tier(model_dir):
    eng = api._get_engine(MODEL, device="cpu")
    assert api._get_engine(MODEL, device="cpu") is eng
    assert eng.device.type == "cpu" and eng.precision == "high"
    fast = api._get_engine(MODEL, quality="fast", device="cpu")
    assert fast is not eng and fast.precision == "default"
    assert any(k.endswith(":high:cpu") for k in api._ENGINE_CACHE)


# --------------------------------------------------------------------------- #
# The segment-stepped offline path
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seconds,against_jax", [(1.0, True), (0.3, False), (1.5, True)])
def test_stepped_path_equals_unstepped_and_reports_like_jax(model_dir, seconds, against_jax):
    """1 s and 0.3 s run as one 112-frame segment, 1.5 s as two.  The port
    pads to whole segments and the JAX package on its x1.5 ladder, so the
    two report other totals, in the same form: ``(0, T)``, then one report
    a segment."""
    x = _speech(7, seconds)
    eng = api._get_engine(MODEL, device="cpu")
    events = []
    stepped = eng.enhance_waveforms(x, progress_callback=lambda d, t: events.append((d, t)))
    plain = eng.enhance_waveforms(x)
    assert torch.equal(torch.from_numpy(stepped), torch.from_numpy(plain))
    assert all(type(d) is int and type(t) is int for d, t in events)
    def reports(T):
        return [(0, T)] + [(min((i + 1) * eng.seg_frames, T), T)
                           for i in range(-(-T // eng.seg_frames))]

    T = events[0][1]
    assert T == eng.seg_frames * (2 if seconds == 1.5 else 1)
    assert events == reports(T)
    # through the API, at the input rate
    api_events = []
    y = api.enhance(x, SR, model=MODEL, device="cpu",
                    progress_callback=lambda d, t: api_events.append((d, t)))
    assert api_events == events
    np.testing.assert_array_equal(y, plain)
    if against_jax:
        jax_events = []
        jax_api.enhance(x, SR, model=MODEL,
                        progress_callback=lambda d, t: jax_events.append((d, t)))
        assert jax_events == reports(jax_events[0][1])
        assert len(jax_events) >= len(events)


# --------------------------------------------------------------------------- #
# Model zoo (downloads faked; nothing is fetched)
# --------------------------------------------------------------------------- #

@pytest.fixture
def tmp_model_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DPDFNET_TPU_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("DPDFNET_TPU_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path


def test_registry_and_names_match_jax():
    assert zoo.supported_models() == jax_zoo.supported_models() == [
        "baseline", "dpdfnet2", "dpdfnet2_48khz_hr", "dpdfnet4", "dpdfnet8",
        "dpdfnet8_48khz_hr"]
    for name in zoo.supported_models():
        a, b = zoo.get_model_info(name), jax_zoo.get_model_info(name)
        assert (a.name, a.sample_rate, a.frame_ms, a.description, a.checkpoint_filename) == \
            (b.name, b.sample_rate, b.frame_ms, b.description, b.checkpoint_filename)
        assert zoo._npz_name(a) == jax_zoo._npz_name(b)
        assert zoo._hf_url(a.checkpoint_filename, "main") == \
            jax_zoo._hf_url(b.checkpoint_filename, "main")
    assert zoo.DEFAULT_MODEL == jax_zoo.DEFAULT_MODEL
    with pytest.raises(ValueError, match="Unsupported model"):
        zoo.get_model_info("nope")


def test_cache_dirs_match_jax(tmp_model_dir, monkeypatch):
    assert zoo.get_cache_dir() == jax_zoo.get_cache_dir()
    assert zoo._candidate_model_dirs() == jax_zoo._candidate_model_dirs()
    monkeypatch.delenv("DPDFNET_TPU_MODEL_DIR")
    monkeypatch.delenv("DPDFNET_TPU_CACHE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_model_dir / "xdg"))
    assert zoo.get_cache_model_dir() == jax_zoo.get_cache_model_dir()
    assert zoo._download_target_dir() == jax_zoo._download_target_dir()


def test_download_fake_writer(tmp_model_dir, monkeypatch):
    def fake_download(url, destination):
        Path(destination).parent.mkdir(parents=True, exist_ok=True)
        Path(destination).write_bytes(b"fake checkpoint")

    monkeypatch.setattr(zoo, "_download_one", fake_download)
    resolved = zoo.download_model(model="dpdfnet2", notifier=lambda m: None)
    assert resolved.checkpoint_path.read_bytes() == b"fake checkpoint"
    # found again without a download; the JAX package finds the same file
    monkeypatch.setattr(zoo, "_download_one", None)
    again = zoo.resolve_model(model="dpdfnet2", auto_download=False)
    assert again.checkpoint_path == resolved.checkpoint_path
    assert jax_zoo.resolve_model(model="dpdfnet2", auto_download=False).checkpoint_path == \
        resolved.checkpoint_path
    assert api.download("dpdfnet2", quiet=True) == resolved.checkpoint_path.parent


def _http(code):
    def fail(url, destination):
        raise HTTPError(url, code, "error", hdrs=None, fp=None)
    return fail


def _url_error(url, destination):
    raise URLError("no route to host")


def _eacces(url, destination):
    raise PermissionError(13, "Permission denied")


@pytest.mark.parametrize("fetch,match,attempts", [
    (_http(403), "HTTP 403", 1),
    (_http(404), "HTTP 404", 1),
    (_http(503), "HTTP 503", 3),
    (_url_error, "Network error", 3),
    (_eacces, "writable location", 1),
])
def test_download_failures(tmp_model_dir, monkeypatch, fetch, match, attempts):
    """Retryable failures take the configured attempts, the others fail
    fast; each ends in a RuntimeError with an actionable message."""
    calls = []

    def counted(url, destination):
        calls.append(url)
        fetch(url, destination)

    monkeypatch.setattr(zoo, "_download_one", counted)
    monkeypatch.setattr(zoo.time, "sleep", lambda s: None)
    with pytest.raises(RuntimeError, match=match):
        zoo.download_model(model="dpdfnet2", notifier=lambda m: None)
    assert len(calls) == attempts


def test_download_transient_retry_succeeds(tmp_model_dir, monkeypatch):
    calls = {"n": 0}

    def flaky(url, destination):
        calls["n"] += 1
        if calls["n"] < 3:
            raise HTTPError(url, 503, "unavailable", hdrs=None, fp=None)
        Path(destination).parent.mkdir(parents=True, exist_ok=True)
        Path(destination).write_bytes(b"ok")

    monkeypatch.setattr(zoo, "_download_one", flaky)
    monkeypatch.setattr(zoo.time, "sleep", lambda s: None)
    resolved = zoo.download_model(model="dpdfnet2", notifier=lambda m: None)
    assert calls["n"] == 3
    assert resolved.checkpoint_path.read_bytes() == b"ok"


def test_env_url_override(tmp_model_dir, monkeypatch):
    seen = {}

    def fake_download(url, destination):
        seen["url"] = url
        Path(destination).parent.mkdir(parents=True, exist_ok=True)
        Path(destination).write_bytes(b"x")

    monkeypatch.setenv("DPDFNET_TPU_HF_BASE_URL", "https://mirror.example")
    monkeypatch.setenv("DPDFNET_TPU_HF_REPO", "me/myrepo")
    monkeypatch.setenv("DPDFNET_TPU_HF_SUBDIR", "ckpt")
    monkeypatch.setattr(zoo, "_download_one", fake_download)
    zoo.download_model(model="baseline", notifier=lambda m: None)
    assert seen["url"].startswith(
        "https://mirror.example/me/myrepo/resolve/main/ckpt/baseline.pth")


def test_unwritable_dir_message(tmp_path, monkeypatch):
    """A model directory that cannot be created fails with the hint (a
    path under a regular file works for root too)."""
    blocker = tmp_path / "file"
    blocker.write_bytes(b"x")
    monkeypatch.setenv("DPDFNET_TPU_MODEL_DIR", str(blocker / "models"))
    monkeypatch.setattr(zoo, "_download_one", None)
    with pytest.raises(RuntimeError, match="writable|Could not create"):
        zoo.download_model(model="dpdfnet2", notifier=lambda m: None)


def test_available_model_entries(tmp_model_dir):
    entries = zoo.available_model_entries()
    assert entries == jax_zoo.available_model_entries()
    assert len(entries) == 6 and all(not e["ready"] for e in entries)
    assert api.available_models() == entries


def test_resolve_model_without_download_raises(tmp_model_dir):
    with pytest.raises(FileNotFoundError, match="Could not resolve"):
        zoo.resolve_model(model="dpdfnet2", auto_download=False)


def test_pth_checkpoint_is_converted_and_cached(tmp_path, monkeypatch):
    """A ``.pth`` with no npz beside it: the zoo converts it, writes its npz
    next to it (no temp file left), and reads that npz on the next call
    without converting again; the JAX package's loader reads the same
    arrays, which are the source weights (a synthetic reference-layout
    checkpoint, ``tools.synth_checkpoint``, whose round trip is exact)."""
    from dpdfnet_tpu.utils.serialization import load_params as jax_load_params
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models import convert
    from dpdfnet_tpu_torch.tools.synth_checkpoint import save_checkpoint
    from dpdfnet_tpu_torch.utils.tree import tree_leaves

    src = port_params_np(MODEL)
    ckpt = tmp_path / "custom.pth"
    save_checkpoint(ckpt, src, get_config(MODEL))
    resolved = zoo.resolve_model(model="dpdfnet2", checkpoint_path=ckpt)
    assert resolved.params_path == tmp_path / "custom.params.npz"
    assert not resolved.params_path.exists()
    p = zoo.load_model_params(resolved, device="cpu")
    assert resolved.params_path.is_file() and not list(tmp_path.glob("*.tmp.npz"))

    def no_convert(*args, **kwargs):
        raise AssertionError("converted again although the npz is cached")

    monkeypatch.setattr(convert, "load_params", no_convert)
    again = zoo.load_model_params(resolved, device="cpu")
    theirs = dict(tree_leaves(jax_load_params(resolved.params_path)))
    ref = dict(tree_leaves(src))
    leaves = list(tree_leaves(p))
    assert [k for k, _ in leaves] == [k for k, _ in tree_leaves(again)]
    assert {k for k, _ in leaves} == set(theirs) == set(ref)
    for (k, x), (_, y) in zip(leaves, tree_leaves(again)):
        assert x.device.type == "cpu" and torch.equal(x, y), k
        assert np.array_equal(x.numpy(), np.asarray(theirs[k])), k
        assert np.array_equal(x.numpy(), ref[k]), k
    with pytest.raises(FileNotFoundError):
        zoo.resolve_model(model="dpdfnet2", checkpoint_path=tmp_path / "missing.pth")


def test_load_model_params_places_on_device(model_dir):
    resolved = zoo.resolve_model(model=MODEL, auto_download=False)
    assert resolved.params_path == model_dir / f"{MODEL}.params.npz"
    assert resolved.params_path == jax_zoo.resolve_model(model=MODEL,
                                                         auto_download=False).params_path
    p = zoo.load_model_params(resolved, device="cpu")
    ref = load_params(resolved.params_path, device="cpu")
    assert torch.equal(p["enc"]["erb_conv0"]["w"], ref["enc"]["erb_conv0"]["w"])
    assert p["enc"]["erb_conv0"]["w"].device.type == "cpu"


def test_save_params_writes_the_jax_format(tmp_path):
    """The port's ``save_params`` (tensors in) writes the JAX package's keys
    and arrays, ``None`` list markers included."""
    from dpdfnet_tpu_torch.utils.serialization import save_params as port_save
    from dpdfnet_tpu_torch.utils.tree import tree_map

    tree = copy.deepcopy(port_params_np(MODEL))
    tree["enc"]["emb_gru"]["grus"].append(None)
    save_params(tmp_path / "jax.npz", tree)
    port_save(tmp_path / "port.npz", tree_map(lambda _, x: torch.from_numpy(x), tree))
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert a.files == b.files and any(k.endswith("#none") for k in a.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------- #
# Streams built by name
# --------------------------------------------------------------------------- #

def _own_engine(model_dir):
    from dpdfnet_tpu_torch.config import get_config

    return Engine(get_config(MODEL), load_params(model_dir / f"{MODEL}.params.npz",
                                                 device="cpu"), device="cpu")


def test_stream_enhancer_by_name_equals_engine_path(model_dir):
    x = _speech(8, 0.5)
    se = StreamEnhancer(model=MODEL, device="cpu")
    assert se._engine is api._get_engine(MODEL, device="cpu")
    ref = StreamEnhancer(engine=_own_engine(model_dir))
    for a, b in ((se.process(x[:1234]), ref.process(x[:1234])),
                 (se.process(x[1234:]), ref.process(x[1234:])), (se.flush(), ref.flush())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["exact", "throughput"])
def test_multistream_by_name_equals_engine_path(model_dir, mode):
    pool = MultiStreamEnhancer(3, model=MODEL, mode=mode, device="cpu")
    ref = MultiStreamEnhancer(3, engine=_own_engine(model_dir), mode=mode)
    sids = [pool.open() for _ in range(3)]
    assert sids == [ref.open() for _ in range(3)]
    xs = [_speech(9 + i, 0.3) for i in range(3)]
    for lo, hi in ((0, 700), (700, 2500), (2500, 4800)):
        got = pool.process_many({s: xs[s][lo:hi] for s in sids})
        want = ref.process_many({s: xs[s][lo:hi] for s in sids})
        for s in sids:
            np.testing.assert_array_equal(got[s], want[s])
    with pytest.raises(ValueError, match="mode"):
        MultiStreamEnhancer(2, model=MODEL, mode="banana", device="cpu")


# --------------------------------------------------------------------------- #
# The port's own host helpers against the JAX package's
# --------------------------------------------------------------------------- #

def _specs():
    rng = np.random.default_rng(0)
    noisy = rng.normal(size=(2, 12, 161, 2)).astype(np.float32)
    enh = rng.normal(size=(2, 12, 161, 2)).astype(np.float32)
    return noisy, enh


@pytest.mark.parametrize("db", [None, 0.0, 6.0, 12.0, float("inf")])
def test_apply_attn_limit_equals_jax(db):
    noisy, enh = _specs()
    np.testing.assert_array_equal(audio.apply_attn_limit(noisy, enh, db),
                                  jax_audio.apply_attn_limit(noisy, enh, db))


def test_apply_attn_limit_rejects_like_jax():
    noisy, enh = _specs()
    for args in ((noisy, enh, -3.0), (noisy, enh, float("nan")), (noisy[:, :6], enh, 6.0)):
        with pytest.raises(ValueError):
            audio.apply_attn_limit(*args)
        with pytest.raises(ValueError):
            jax_audio.apply_attn_limit(*args)


@pytest.mark.parametrize("n,target", [(100, 160), (160, 160), (300, 160), (0, 5)])
def test_fit_length_equals_jax(n, target):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got, ref = audio.fit_length(x, target), jax_audio.fit_length(x, target)
    assert got.dtype == ref.dtype and got.shape == (target,)
    np.testing.assert_array_equal(got, ref)


def test_pcm16_safe_equals_jax():
    x = np.concatenate([np.linspace(-1.5, 1.5, 1001),
                        np.random.default_rng(1).normal(size=999)]).astype(np.float32)
    got, ref = audio.pcm16_safe(x), jax_audio.pcm16_safe(x)
    assert got.dtype == ref.dtype == np.int16
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("win", [320, 960])
def test_make_stft_config_equals_jax(win):
    a, b = audio.make_stft_config(win), jax_audio.make_stft_config(win)
    assert (a.win_len, a.hop_size) == (b.win_len, b.hop_size)
    np.testing.assert_array_equal(a.window, b.window)
    assert not a.window.flags.writeable


def test_resample_takes_soxr_when_it_imports(monkeypatch):
    """With a ``soxr`` module importable, ``auto`` routes through it (HQ);
    ``DPDFNET_TPU_RESAMPLER=scipy`` keeps the polyphase path."""
    import sys
    import types

    calls = []
    fake = types.ModuleType("soxr")
    fake.resample = lambda x, a, b, quality=None: calls.append(quality) or np.zeros(7)
    monkeypatch.setitem(sys.modules, "soxr", fake)
    x = np.ones(160, np.float32)
    assert audio.resample(x, 16000, 48000).shape == (7,) and calls == ["HQ"]
    monkeypatch.setenv("DPDFNET_TPU_RESAMPLER", "scipy")
    np.testing.assert_array_equal(audio.resample(x, 16000, 48000),
                                  jax_audio.resample(x, 16000, 48000))
    assert calls == ["HQ"]


def test_lazy_facade_exports():
    import dpdfnet_tpu_torch as pkg

    for name in ("enhance", "enhance_file", "enhance_batch", "available_models", "download"):
        assert getattr(pkg, name) is getattr(api, name)
    for name in ("zoo", "audio_io", "metrics", "demo", "serving"):
        assert getattr(pkg, name).__name__ == f"dpdfnet_tpu_torch.{name}"
    with pytest.raises(AttributeError):
        pkg.nope
    assert os.path.basename(pkg.api.__file__) == "api.py"
