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

from dpdfnet_tpu_torch.models.fuse import _pack_bidir
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
