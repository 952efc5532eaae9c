"""The port's ``export`` against the JAX package's: the traceable flat-state
adapters, the sidecar and initial state, the streaming artifact frame by
frame, the offline artifact, the standalone consumer in a fresh process,
and the kernel ops the artifacts hold.

Weights: the JAX package's ``init_params`` + ``contract_params`` on
``dpdfnet2``, carried across with ``params_from_jax``; signals from numpy
seeds.  The JAX side runs on the CPU as ``tests/test_export.py`` runs it,
the port's artifacts are exported on the CPU (``device="cpu"``), where
each ``torch.ops.dpdfnet.*`` op runs its kernel's plain version.

Tolerances: the flat-state adapters exactly (atol 0: they move floats);
the streaming artifact within 1e-5 of the JAX artifact (the network's
float32 rounding over a few frames, below ``test_torch_model.py``'s 3e-5
bound of ``forward_spec``); the offline artifact within 1e-4 of the JAX
engine (the engine bound, ROADMAP queue 3); the consumer within 2e-4 of
``StreamEnhancer`` (16-bit output quantisation, as in ``test_export.py``).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.library import opcheck

from dpdfnet_tpu import export as jax_export
from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import state as jax_state
from dpdfnet_tpu.runtime.engine import Engine as JaxEngine

from dpdfnet_tpu_torch import export as ex
from dpdfnet_tpu_torch.audio_io import read_wav, write_wav
from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models.state import state_size
from dpdfnet_tpu_torch.ops import gru_kernels
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.stream import StreamEnhancer
from dpdfnet_tpu_torch.utils.serialization import params_from_jax

from torch_testing import jax_params_np

ROOT = Path(__file__).resolve().parent.parent
MODEL = "dpdfnet2"


@pytest.fixture(scope="module")
def weights():
    pj = jax_params_np(MODEL)
    return pj, params_from_jax(pj, device="cpu")


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """The JAX and the port's streaming artifacts and the port's offline
    artifact (B=2 x the bucket a 0.5 s utterance is padded to)."""
    pj, pt = weights
    d = tmp_path_factory.mktemp("export")
    cfg = get_config(MODEL)
    S = Engine(cfg, pt, device="cpu").bucket_len(cfg.sample_rate // 2)
    return {
        "jax": jax_export.export_stream(pj, jax_get_config(MODEL), d / "j.stablehlo"),
        "stream": ex.export_stream(pt, cfg, d / f"{MODEL}.stream.pt2", device="cpu"),
        "offline": ex.export_offline(pt, cfg, d / f"{MODEL}.offline.pt2", batch=2,
                                     seconds=S / cfg.sample_rate, device="cpu"),
    }


@functools.lru_cache(maxsize=None)
def _jax_state(name, B, seed):
    """A JAX state of ``name`` for B streams with every element drawn from a
    normal distribution (the ring slots a flat state drops included), made
    once per file and shared by the flatten and unflatten cases."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.normal(size=v.shape).astype(np.asarray(v).dtype)),
        jax_state.init_state(jax_get_config(name), B))


def _to_torch(st):
    return {k: ([torch.from_numpy(np.asarray(h)) for h in v] if isinstance(v, list)
                else torch.from_numpy(np.asarray(v))) for k, v in st.items()}


@pytest.mark.parametrize("name", ["dpdfnet2", "dpdfnet2_48khz_hr"])
def test_flatten_t_equals_flatten_jnp(name):
    st = _jax_state(name, 2, seed=0)
    want = np.asarray(jax_export._flatten_jnp(jax_get_config(name), st))
    got = ex._flatten_t(get_config(name), _to_torch(st)).numpy()
    assert got.shape == (2, state_size(get_config(name)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["dpdfnet2", "dpdfnet2_48khz_hr"])
def test_unflatten_t_equals_unflatten_jnp(name):
    flat = np.asarray(jax_export._flatten_jnp(jax_get_config(name), _jax_state(name, 2, 0)))
    want = jax_export._unflatten_jnp(jax_get_config(name), jnp.asarray(flat))
    got = ex._unflatten_t(get_config(name), torch.from_numpy(flat))
    assert list(got) == list(want)
    for k, v in want.items():
        for a, b in zip(got[k] if isinstance(v, list) else [got[k]],
                        v if isinstance(v, list) else [v]):
            assert a.is_contiguous()
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sidecar_and_initial_state_match_jax(artifacts):
    meta_j = json.loads(Path(str(artifacts["jax"]) + ".json").read_text())
    meta = json.loads(Path(str(artifacts["stream"]) + ".json").read_text())
    assert set(meta) - set(meta_j) == {"precision"}
    assert set(meta_j) - set(meta) == set()
    for k in meta_j:
        if k != "platforms":
            assert meta[k] == meta_j[k], k
    assert meta["platforms"] == ["cpu"] and meta["precision"] == "high"
    np.testing.assert_array_equal(ex.build_initial_flat_state(meta),
                                  jax_export.build_initial_flat_state(meta_j))


def test_stream_artifact_matches_jax_artifact_frame_by_frame(artifacts):
    """Output within 1e-5; the carried flat state within 1e-5 of each
    element's magnitude (at least 1): its EMA norm means are in dB, near
    -70, where a float32 ulp is 7.6e-6."""
    cfg = get_config(MODEL)
    loaded_j = jax_export.load_exported(artifacts["jax"])
    loaded = ex.load_exported(artifacts["stream"])
    init = ex.build_initial_flat_state(loaded.meta)[None]
    rng = np.random.default_rng(2)
    frames = (0.1 * rng.normal(size=(8, 1, 1, cfg.freq_bins, 2))).astype(np.float32)
    flat_j, flat = jnp.asarray(init), torch.from_numpy(init)
    out_err = state_err = 0.0
    for t in range(frames.shape[0]):
        o_j, flat_j = loaded_j.call(jnp.asarray(frames[t]), flat_j)
        o, flat = loaded.call(torch.from_numpy(frames[t]), flat)
        out_err = max(out_err, float(np.abs(o.numpy() - np.asarray(o_j)).max()))
        ref = np.asarray(flat_j)
        state_err = max(state_err, float((np.abs(flat.numpy() - ref)
                                          / np.maximum(np.abs(ref), 1.0)).max()))
    assert out_err <= 1e-5 and state_err <= 1e-5, (out_err, state_err)


def test_offline_artifact_matches_jax_engine(artifacts, weights):
    pj, pt = weights
    cfg = get_config(MODEL)
    rng = np.random.default_rng(4)
    S0 = cfg.sample_rate // 2
    wav = (0.1 * rng.normal(size=(2, S0))).astype(np.float32)
    loaded = ex.load_exported(artifacts["offline"])
    S = loaded.meta["samples"]
    assert S == Engine(cfg, pt, device="cpu").bucket_len(S0)
    padded = np.zeros((2, S), np.float32)
    padded[:, :S0] = wav
    got = loaded.call(torch.from_numpy(padded), torch.zeros(())).numpy()[:, :S0]
    ref = JaxEngine(jax_get_config(MODEL), pj).enhance_waveforms(wav)
    assert np.isfinite(got).all()
    assert float(np.abs(got - np.asarray(ref)).max()) <= 1e-4


def test_consumer_runs_artifact_without_model_code(artifacts, weights, tmp_path):
    """A fresh process with ``tools/consume_exported.py`` (torch, numpy and
    the kernel ops; no model code) gives the in-process streaming engine's
    audio, the port's counterpart of ``test_export.py``'s consumer test."""
    _, pt = weights
    cfg = get_config(MODEL)
    script = ROOT / "dpdfnet_tpu_torch" / "tools" / "consume_exported.py"
    allowed = ("import json", "import sys", "import wave", "from pathlib import Path",
               "import numpy as np", "import torch", "import dpdfnet_tpu_torch.ops.gru_kernels")
    imports = [ln.strip() for ln in script.read_text().splitlines()
               if ln.startswith(("import ", "from "))]
    assert imports and all(ln.startswith(allowed) for ln in imports), imports

    rng = np.random.default_rng(5)
    in_wav, out_wav = tmp_path / "in.wav", tmp_path / "out.wav"
    write_wav(in_wav, (0.1 * rng.normal(size=cfg.sample_rate)).astype(np.float32),
              cfg.sample_rate, subtype="PCM_16")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "dpdfnet_tpu_torch.tools.consume_exported",
                        str(artifacts["stream"]), str(in_wav), str(out_wav)],
                       capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    modules = json.loads(r.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    assert "dpdfnet_tpu_torch.ops.gru_kernels" in modules
    banned = ("dpdfnet_tpu_torch.models", "dpdfnet_tpu_torch.runtime",
              "dpdfnet_tpu_torch.export", "dpdfnet_tpu_torch.stream")
    assert not [m for m in modules if m.startswith(banned)], modules

    got, sr = read_wav(out_wav)
    assert sr == cfg.sample_rate
    se = StreamEnhancer(engine=Engine(cfg, pt, device="cpu"))
    quantized = np.asarray(read_wav(in_wav)[0], np.float32)
    ref = np.concatenate([se.process(quantized), se.flush()])
    n = min(got.shape[0], ref.shape[0])
    assert n > cfg.hop * 50
    assert float(np.abs(got[:n] - ref[:n]).max()) <= 2e-4


def test_exported_cpu_step_holds_the_kernel_ops(artifacts):
    program = ex.load_exported(artifacts["stream"]).program
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    kernels = {o for o in ops if o.startswith("dpdfnet.")}
    cfg = get_config(MODEL)
    assert kernels == {"dpdfnet.dprnn_intra_block.default", "dpdfnet.dprnn_inter_block.default",
                       "dpdfnet.gru_scan.default"}
    assert ops.count("dpdfnet.dprnn_intra_block.default") == 2 * cfg.dprnn_blocks
    assert ops.count("dpdfnet.gru_scan.default") == 5


def _r(rng, *shape):
    return torch.from_numpy((0.3 * rng.normal(size=shape)).astype(np.float32))


def _op_cases():
    """Each op at a small shape (C = 8: the plain versions take any width)."""
    rng = np.random.default_rng(9)
    C, H = 8, 8
    ln = (_r(rng, C), 1.0 + _r(rng, C), _r(rng, C))
    intra_w = (_r(rng, 2 * C, 6 * C), _r(rng, 2 * C, 6 * C), _r(rng, 2, 6 * C),
               _r(rng, 2 * C, C)) + ln
    inter_w = (_r(rng, C, 3 * C), _r(rng, 3 * C), _r(rng, C, 3 * C), _r(rng, 3 * C),
               _r(rng, C, C)) + ln
    stack = [_r(rng, *shape) for shape in gru_kernels._stack_shapes(2, C).values()]
    return {
        "dprnn_intra_block": (_r(rng, 3, 5, C), *intra_w, 0),
        "dprnn_intra_block/fm": (_r(rng, 5, 6, C), *intra_w, 2),
        "dprnn_inter_block": (_r(rng, 2, 3, 5, C), _r(rng, 2, 5, C), *inter_w, 0, False, False),
        "dprnn_inter_block/fm": (_r(rng, 3, 10, C), _r(rng, 10, C), *inter_w, 2, False, True),
        "relayout_fm": (_r(rng, 2, 3, 4, C), torch.bfloat16),
        "gru_bidir": (_r(rng, 3, 5, C), *intra_w[:3]),
        "dprnn_stack": (_r(rng, 2, 2, 5, C), _r(rng, 2, 2, 5, C), stack),
        "gru_scan": (_r(rng, 3, 4, 6), _r(rng, 3, H), _r(rng, 6, 3 * H), _r(rng, 3 * H),
                     _r(rng, H, 3 * H), _r(rng, 3 * H), True),
        "dprnn_intra_block_v2": (_r(rng, 3, 5, C), _r(rng, C, 6 * C), _r(rng, 2 * C, 8 * C),
                                 _r(rng, 2, 6 * C), *ln, True),
        "dprnn_inter_block_v2": (_r(rng, 2, 3, 5, 3 * C), _r(rng, 2, 3, 5, C),
                                 _r(rng, 2, 5, C), _r(rng, C, 4 * C), _r(rng, 3 * C), *ln),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_kernel_op_schema_and_fake(case):
    """``torch.library.opcheck`` on each kernel op at a small CPU shape: the
    schema, the fake implementation against the CPU one, and a trace with
    dynamic shapes."""
    name = case.split("/")[0]
    assert name in gru_kernels.KERNEL_WRAPPERS
    opcheck(getattr(torch.ops.dpdfnet, name).default, _op_cases()[case])
