"""The port's multi-host pieces against the JAX package's.

``shard_files_for_host`` and ``host_info`` case for case against the JAX
functions (the same shards, the same values, the same errors);
``local_mesh`` over this process's GPUs; ``initialize`` bringing up a
gloo process group in two processes; and ``enhance-dir --num-hosts 2
--host-id k`` (and ``DPDFNET_TPU_NUM_HOSTS``), whose two runs write
the files of one run (each within one 16-bit step of it: the batches
group other utterances, which may move a value across a rounding
boundary).
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from dpdfnet_tpu.parallel import multihost as jax_multihost

from dpdfnet_tpu_torch import api, audio_io, cli
from dpdfnet_tpu_torch.parallel import multihost
from dpdfnet_tpu_torch.utils.serialization import save_params

from torch_testing import port_params_np

REPO = Path(__file__).resolve().parent.parent
MODEL = "dpdfnet2"

FILES = [f"f{i:03d}" for i in range(23)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 23, 40])
def test_shard_files_for_host_matches_jax(n):
    shards = [multihost.shard_files_for_host(FILES, h, n) for h in range(n)]
    assert shards == [jax_multihost.shard_files_for_host(FILES, h, n) for h in range(n)]
    flat = [f for s in shards for f in s]
    assert sorted(flat) == FILES and len(flat) == len(set(flat))


@pytest.mark.parametrize("env,args", [
    ({}, (None, None)),
    ({"DPDFNET_TPU_HOST_ID": "2", "DPDFNET_TPU_NUM_HOSTS": "4"}, (None, None)),
    ({"DPDFNET_TPU_HOST_ID": "2", "DPDFNET_TPU_NUM_HOSTS": "4"}, (1, 3)),
    ({"DPDFNET_TPU_NUM_HOSTS": "4"}, (None, None)),
    ({"DPDFNET_TPU_HOST_ID": "1"}, (None, None)),
    ({}, (5, 4)),
    ({}, (-1, 4)),
    ({}, (0, None)),
    ({"DPDFNET_TPU_NUM_HOSTS": "3"}, (2, None)),
])
def test_host_info_matches_jax(monkeypatch, env, args):
    """The same resolution order and the same errors; without either the
    JAX function reads the JAX process count and the port the (absent)
    process group, both ``(0, 1)`` here."""
    for k in ("DPDFNET_TPU_HOST_ID", "DPDFNET_TPU_NUM_HOSTS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        want = jax_multihost.host_info(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            multihost.host_info(*args)
        assert str(got.value) == str(e)
        return
    assert multihost.host_info(*args) == want
    assert multihost.shard_files_for_host(FILES, *args) == \
        jax_multihost.shard_files_for_host(FILES, *args)


def test_local_mesh(monkeypatch):
    """Every visible GPU, or this local rank's share of them; without a GPU
    it raises as ``make_mesh`` does."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.local_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert [d.index for d in multihost.local_mesh().devices] == [0, 1, 2, 3]
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert [str(d) for d in multihost.local_mesh().devices] == ["cuda:1", "cuda:3"]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "6")
    assert [str(d) for d in multihost.local_mesh().devices] == ["cuda:2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_in_two_gloo_processes(tmp_path):
    """Two processes with torchrun's variables: each brings the group up
    (twice: the second call is a no-op), reads its rank from ``host_info``
    and its shard of a file list, and sums its rank over the group."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import torch
        import torch.distributed as dist
        from dpdfnet_tpu_torch.parallel import multihost

        multihost.initialize()
        multihost.initialize()
        rank, n = multihost.host_info()
        t = torch.tensor([float(rank)])
        dist.all_reduce(t)
        files = multihost.shard_files_for_host([f"f{i}" for i in range(5)])
        print(dist.get_backend(), rank, n, float(t), ",".join(files))
    """))
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
               PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    env.pop("DPDFNET_TPU_NUM_HOSTS", None)
    env.pop("DPDFNET_TPU_HOST_ID", None)
    procs = [subprocess.Popen([sys.executable, str(script)], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs == [["gloo", "0", "2", "1.0", "f0,f2,f4"], ["gloo", "1", "2", "1.0", "f1,f3"]]


@pytest.fixture
def model_dir(tmp_path, monkeypatch):
    d = tmp_path / "models"
    d.mkdir()
    save_params(d / f"{MODEL}.params.npz", port_params_np(MODEL))
    monkeypatch.setenv("DPDFNET_TPU_MODEL_DIR", str(d))
    monkeypatch.setenv("DPDFNET_TPU_CACHE_DIR", str(d / "cache"))
    monkeypatch.setenv("NO_BANNER", "1")
    for k in ("DPDFNET_TPU_HOST_ID", "DPDFNET_TPU_NUM_HOSTS"):
        monkeypatch.delenv(k, raising=False)
    api.clear_engine_cache()
    yield d
    api.clear_engine_cache()


def _enhance_dir(src, out, *extra):
    return cli.main(["enhance-dir", str(src), str(out), "--model", MODEL, "--device", "cpu",
                     "--workers", "2", *extra])


def test_enhance_dir_host_shards_union_to_one_run(model_dir, tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(3)
    src = tmp_path / "in"
    src.mkdir()
    for i in range(5):
        audio_io.write_wav(src / f"u{i}.wav",
                           (0.1 * rng.normal(size=1600 + 160 * i)).astype(np.float32), 16000)
    assert _enhance_dir(src, tmp_path / "all") == 0
    whole = {p.name: audio_io.read_wav(p)[0] for p in (tmp_path / "all").iterdir()}
    assert len(whole) == 5

    shards = []
    for host in range(2):
        out = tmp_path / f"out{host}"
        assert _enhance_dir(src, out, "--num-hosts", "2", "--host-id", str(host)) == 0
        assert f"[INFO] host {host}/2: processing {3 - host} of 5 files" in \
            capsys.readouterr().out
        shards.append({p.name: audio_io.read_wav(p)[0] for p in out.iterdir()})
    assert set(shards[0]).isdisjoint(shards[1])
    union = {**shards[0], **shards[1]}
    assert sorted(union) == sorted(whole)
    for name, x in union.items():
        assert x.shape == whole[name].shape
        assert float(np.abs(x - whole[name]).max()) <= 1.0 / 32768.0, name

    # the environment alone shards too; a host with no files exits early
    monkeypatch.setenv("DPDFNET_TPU_NUM_HOSTS", "8")
    monkeypatch.setenv("DPDFNET_TPU_HOST_ID", "6")
    assert _enhance_dir(src, tmp_path / "none") == 0
    assert "[INFO] host 6/8: processing 0 of 5 files" in capsys.readouterr().out
    assert not (tmp_path / "none").exists()
