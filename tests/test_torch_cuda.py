"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: skipped where no CUDA device is present (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with a card and no JAX (``--noconftest`` skips
``tests/conftest.py``, which sets JAX up):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance 1e-4 max-abs: the same float32 arithmetic summed in another
order (see ``chip_smoke.py``, which also checks the flagship shapes).
"""

import numpy as np
import pytest
import torch

from dpdfnet_tpu_torch.models.fuse import _pack_bidir, pack_stack
from dpdfnet_tpu_torch.ops import gru_kernels

TOL = 1e-4


def _gru(rng, I, H, dev):
    return {"wi": torch.tensor(rng.normal(size=(I, 3 * H)) * 0.3, dtype=torch.float32, device=dev),
            "bi": torch.tensor(rng.normal(size=(3 * H,)) * 0.1, dtype=torch.float32, device=dev),
            "wh": torch.tensor(rng.normal(size=(H, 3 * H)) * 0.3, dtype=torch.float32, device=dev),
            "bh": torch.tensor(rng.normal(size=(3 * H,)) * 0.1, dtype=torch.float32, device=dev)}


def _rand(rng, shape, dev, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,Fq", [(30, 40), (7, 48)])
def test_cuda_intra_matches_plain(dev, N, Fq):
    rng = np.random.default_rng(6)
    C = 64
    wi2, wh2, b2 = _pack_bidir(_gru(rng, C, C, dev), _gru(rng, C, C, dev))
    epi = (_rand(rng, (2 * C, C), dev, 0.3), _rand(rng, (C,), dev, 0.1),
           1.0 + _rand(rng, (C,), dev, 0.5), _rand(rng, (C,), dev, 0.1))
    x = _rand(rng, (N, Fq, C), dev)
    got = gru_kernels.dprnn_intra_block(x, wi2, wh2, b2, *epi)
    ref = gru_kernels.dprnn_intra_block_plain(x, wi2, wh2, b2, *epi)
    assert (got - ref).abs().max().item() < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Fq", [(3, 10, 40), (1, 7, 48)])
def test_cuda_inter_matches_plain(dev, B, T, Fq):
    rng = np.random.default_rng(7)
    C = 64
    p = _gru(rng, C, C, dev)
    args = (p["wi"], p["bi"], p["wh"], p["bh"], _rand(rng, (C, C), dev, 0.3),
            _rand(rng, (C,), dev, 0.1), 1.0 + _rand(rng, (C,), dev, 0.5),
            _rand(rng, (C,), dev, 0.1))
    x = _rand(rng, (B, T, Fq, C), dev)
    h0 = _rand(rng, (B, Fq, C), dev, 0.2)
    out, hl = gru_kernels.dprnn_inter_block(x, h0, *args)
    ref, hl_ref = gru_kernels.dprnn_inter_block_plain(x, h0, *args)
    assert (out - ref).abs().max().item() < TOL
    assert (hl - hl_ref).abs().max().item() < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,I,H", [(3, 9, 256, 256), (150, 5, 40, 64), (600, 3, 24, 32)])
def test_cuda_gru_scan_matches_plain(dev, reverse, N, T, I, H):
    rng = np.random.default_rng(8)
    p = _gru(rng, I, H, dev)
    x = _rand(rng, (N, T, I), dev)
    h0 = _rand(rng, (N, H), dev, 0.2)
    ys, hl = gru_kernels.gru_scan(x, h0, p["wi"], p["bi"], p["wh"], p["bh"], reverse=reverse)
    ys_ref, hl_ref = gru_kernels.gru_scan_plain(x, h0, p["wi"], p["bi"], p["wh"], p["bh"],
                                                reverse=reverse)
    assert (ys - ys_ref).abs().max().item() < TOL
    assert (hl - hl_ref).abs().max().item() < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N,L", [(30, 40), (7, 48), (200, 8)])
def test_cuda_gru_bidir_matches_plain(dev, N, L):
    rng = np.random.default_rng(9)
    C = 64
    w = _pack_bidir(_gru(rng, C, C, dev), _gru(rng, C, C, dev))
    x = _rand(rng, (N, L, C), dev)
    got = gru_kernels.gru_bidir(x, *w)
    ref = gru_kernels.gru_bidir_plain(x, *w)
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() < TOL


def _stacked(rng, K, C, dev):
    blocks = []
    for _ in range(K):
        fw, bw = _gru(rng, C, C, dev), _gru(rng, C, C, dev)
        wi2, wh2, b2 = _pack_bidir(fw, bw)
        blocks.append({
            "intra": {"packed": {"wi2": wi2, "wh2": wh2, "b2": b2},
                      "fc": {"w": _rand(rng, (2 * C, C), dev, 0.3), "b": _rand(rng, (C,), dev, 0.1)},
                      "ln": {"g": 1.0 + _rand(rng, (C,), dev, 0.5), "b": _rand(rng, (C,), dev, 0.1)}},
            "inter": {"gru": _gru(rng, C, C, dev),
                      "fc": {"w": _rand(rng, (C, C), dev, 0.3), "b": _rand(rng, (C,), dev, 0.1)},
                      "ln": {"g": 1.0 + _rand(rng, (C,), dev, 0.5), "b": _rand(rng, (C,), dev, 0.1)}},
        })
    return pack_stack(blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Fq,K", [(3, 1, 48, 2), (2, 4, 40, 3), (5, 2, 8, 2), (1, 3, 13, 1)])
def test_cuda_dprnn_stack_matches_plain(dev, B, T, Fq, K):
    rng = np.random.default_rng(10)
    C = 64
    stacked = _stacked(rng, K, C, dev)
    x = _rand(rng, (B, T, Fq, C), dev)
    h0 = _rand(rng, (K, B, Fq, C), dev, 0.2)
    out, hl = gru_kernels.dprnn_stack(x, h0, stacked)
    ref, hl_ref = gru_kernels.dprnn_stack_plain(x, h0, stacked)
    assert (out - ref).abs().max().item() < TOL
    assert (hl - hl_ref).abs().max().item() < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("stack", ["0", "1"])
def test_cuda_exact_streaming_is_bit_invariant_to_chunking(dev, monkeypatch, stack):
    """Exact mode on the card: the same frames cut three ways give the same
    bits, with the per-stage DPRNN kernels and with the stack kernel."""
    from dpdfnet_tpu_torch import Engine, get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params

    monkeypatch.setenv("DPDFNET_TPU_STACK", stack)
    cfg = get_config("dpdfnet2")
    eng = Engine(cfg, contract_params(init_params(cfg, seed=0, device=dev)), device=dev)
    assert ("dprnn_df_stacked" in eng.params["enc"]) == (stack == "1")
    frames = (0.1 * np.random.default_rng(11).normal(size=(3, 9, cfg.win_len))).astype(np.float32)
    outs = []
    for cuts in ([9], [1] * 9, [2, 4, 3]):
        st, ys, pos = eng.init_stream_state(batch=3), [], 0
        for n in cuts:
            y, st = eng.process_frames(frames[:, pos:pos + n], st)
            ys.append(y)
            pos += n
        outs.append(np.concatenate(ys, axis=1))
    assert np.isfinite(outs[0]).all()
    for y in outs[1:]:
        np.testing.assert_array_equal(y, outs[0])
