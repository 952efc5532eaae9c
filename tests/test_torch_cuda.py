"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: skipped where no CUDA device is present (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with a card and no JAX (``--noconftest`` skips
``tests/conftest.py``, which sets JAX up):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance 1e-4 max-abs: the same float32 arithmetic summed in another
order (see ``chip_smoke.py``, which also checks the flagship shapes);
bfloat16 planes are held to it under ``gru_kernels.err_beyond_bf16_ulp``.  Intra v2 with bfloat16 input
projections (``xp_bf16``) is held to 1e-4 on inputs whose products
``x . wi_cat`` are exact in float32 in any summation order
(``kernel_ab.on_grid``), so the kernel and torch.matmul round the same
values to bfloat16.
"""

import numpy as np
import pytest
import torch

from dpdfnet_tpu_torch.models.fuse import _pack_bidir, pack_stack
from dpdfnet_tpu_torch.ops import gru_kernels
from dpdfnet_tpu_torch.tools.kernel_ab import on_grid

TOL = 1e-4
BF16 = torch.bfloat16


def _close(got, ref, tol=TOL):
    assert gru_kernels.err_beyond_bf16_ulp(got, ref) < tol


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
@pytest.mark.parametrize("N,T,I,H", [
    (3, 9, 256, 256), (150, 5, 40, 64), (600, 3, 24, 32),
    # the cluster plan's edges: one row, 1 / 2 / 4 / 8 rows per cluster,
    # a cluster of 3 CTAs (H = 96), T == 1
    (1, 7, 256, 256), (16, 4, 256, 256), (17, 3, 256, 256), (65, 2, 256, 256),
    (64, 1, 256, 256), (9, 6, 50, 96), (33, 5, 128, 128)])
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
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_gru_scan_batch_invariant(dev, reverse, plane):
    """Row i of a batch of 64 (4 rows per cluster) equals the same row run
    alone (1 row per cluster) and within a batch of 17: max-abs 0."""
    rng = np.random.default_rng(20)
    p = _gru(rng, 256, 256, dev)
    x = _rand(rng, (64, 12, 256), dev).to(plane)
    h0 = _rand(rng, (64, 256), dev, 0.2)
    args = (p["wi"], p["bi"], p["wh"], p["bh"])
    ys, hl = gru_kernels.gru_scan(x, h0, *args, reverse=reverse)
    for i in (0, 5, 63):
        ys1, hl1 = gru_kernels.gru_scan(x[i:i + 1].contiguous(), h0[i:i + 1].contiguous(), *args,
                                        reverse=reverse)
        assert torch.equal(ys1[0], ys[i]) and torch.equal(hl1[0], hl[i])
    ys17, hl17 = gru_kernels.gru_scan(x[:17].contiguous(), h0[:17].contiguous(), *args,
                                      reverse=reverse)
    assert torch.equal(ys17, ys[:17]) and torch.equal(hl17, hl[:17])


@pytest.mark.cuda
@pytest.mark.parametrize("H", [288, 512])
def test_cuda_gru_scan_raises_above_its_h_limit(dev, H):
    """H above 256 (a cluster of more than 8 CTAs) raises; nothing falls back."""
    rng = np.random.default_rng(21)
    p = _gru(rng, 32, H, dev)
    gru_kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="from 32 to 256"):
        gru_kernels.gru_scan(_rand(rng, (2, 3, 32), dev), _rand(rng, (2, H), dev), p["wi"],
                             p["bi"], p["wh"], p["bh"])
    assert gru_kernels.launch_counts()["gru_scan"] == 0


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


def _stacked(rng, K, C, dev, scale=0.3):
    """K random DPRNN blocks in pack_stack form, weights at ``scale``
    (LayerNorm gains 1 + N(0, scale + 0.2); the other tests draw at 0.3)."""
    def gru():
        g = _gru(rng, C, C, dev)
        if scale != 0.3:
            g["wi"], g["wh"] = g["wi"] * (scale / 0.3), g["wh"] * (scale / 0.3)
        return g

    blocks = []
    for _ in range(K):
        fw, bw = gru(), gru()
        wi2, wh2, b2 = _pack_bidir(fw, bw)
        blocks.append({
            "intra": {"packed": {"wi2": wi2, "wh2": wh2, "b2": b2},
                      "fc": {"w": _rand(rng, (2 * C, C), dev, scale), "b": _rand(rng, (C,), dev, 0.1)},
                      "ln": {"g": 1.0 + _rand(rng, (C,), dev, scale + 0.2), "b": _rand(rng, (C,), dev, 0.1)}},
            "inter": {"gru": gru(),
                      "fc": {"w": _rand(rng, (C, C), dev, scale), "b": _rand(rng, (C,), dev, 0.1)},
                      "ln": {"g": 1.0 + _rand(rng, (C,), dev, scale + 0.2), "b": _rand(rng, (C,), dev, 0.1)}},
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


@pytest.mark.cuda
@pytest.mark.parametrize("N,Fq", [(30, 40), (7, 48)])
def test_cuda_intra_bf16_plane_matches_plain(dev, N, Fq):
    rng = np.random.default_rng(12)
    C = 64
    wi2, wh2, b2 = _pack_bidir(_gru(rng, C, C, dev), _gru(rng, C, C, dev))
    epi = (_rand(rng, (2 * C, C), dev, 0.3), _rand(rng, (C,), dev, 0.1),
           1.0 + _rand(rng, (C,), dev, 0.5), _rand(rng, (C,), dev, 0.1))
    x = _rand(rng, (N, Fq, C), dev).to(BF16)
    gru_kernels.reset_launch_counts()
    got = gru_kernels.dprnn_intra_block(x, wi2, wh2, b2, *epi)
    assert gru_kernels.launch_counts()["dprnn_intra_block"] == 1
    _close(got, gru_kernels.dprnn_intra_block_plain(x, wi2, wh2, b2, *epi))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Fq", [(3, 10, 40), (1, 7, 48)])
def test_cuda_inter_bf16_plane_matches_plain(dev, B, T, Fq):
    rng = np.random.default_rng(13)
    C = 64
    p = _gru(rng, C, C, dev)
    args = (p["wi"], p["bi"], p["wh"], p["bh"], _rand(rng, (C, C), dev, 0.3),
            _rand(rng, (C,), dev, 0.1), 1.0 + _rand(rng, (C,), dev, 0.5),
            _rand(rng, (C,), dev, 0.1))
    x = _rand(rng, (B, T, Fq, C), dev).to(BF16)
    h0 = _rand(rng, (B, Fq, C), dev, 0.2)
    out, hl = gru_kernels.dprnn_inter_block(x, h0, *args)
    ref, hl_ref = gru_kernels.dprnn_inter_block_plain(x, h0, *args)
    _close(out, ref)
    _close(hl, hl_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_gru_scan_bf16_plane_matches_plain(dev, reverse):
    rng = np.random.default_rng(14)
    p = _gru(rng, 256, 256, dev)
    x = _rand(rng, (5, 9, 256), dev).to(BF16)
    h0 = _rand(rng, (5, 256), dev, 0.2)
    ys, hl = gru_kernels.gru_scan(x, h0, p["wi"], p["bi"], p["wh"], p["bh"], reverse=reverse)
    ys_ref, hl_ref = gru_kernels.gru_scan_plain(x, h0, p["wi"], p["bi"], p["wh"], p["bh"],
                                                reverse=reverse)
    _close(ys, ys_ref)
    _close(hl, hl_ref)


@pytest.mark.cuda
def test_cuda_gru_bidir_and_stack_bf16_plane_match_plain(dev):
    rng = np.random.default_rng(15)
    C = 64
    w = _pack_bidir(_gru(rng, C, C, dev), _gru(rng, C, C, dev))
    x = _rand(rng, (9, 40, C), dev).to(BF16)
    for a, b in zip(gru_kernels.gru_bidir(x, *w), gru_kernels.gru_bidir_plain(x, *w)):
        _close(a, b)
    stacked = _stacked(rng, 2, C, dev)
    x = _rand(rng, (3, 2, 48, C), dev).to(BF16)
    h0 = _rand(rng, (2, 3, 48, C), dev, 0.2)
    out, hl = gru_kernels.dprnn_stack(x, h0, stacked)
    ref, hl_ref = gru_kernels.dprnn_stack_plain(x, h0, stacked)
    _close(out, ref)
    _close(hl, hl_ref)


def _intra_v2_args(rng, C, dev):
    wi2, wh2, b2 = _pack_bidir(_gru(rng, C, C, dev), _gru(rng, C, C, dev))
    wfc = _rand(rng, (2 * C, C), dev, 0.3)
    wi_cat, wh_big = gru_kernels.pack_intra_v2(wi2, wh2, wfc)
    return (wi_cat, wh_big, b2, _rand(rng, (C,), dev, 0.1), 1.0 + _rand(rng, (C,), dev, 0.5),
            _rand(rng, (C,), dev, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("N,L", [(30, 40), (7, 48), (200, 8)])
def test_cuda_intra_v2_matches_plain(dev, N, L, plane):
    """f32 input projections: the 1e-4 bound (one bf16 ulp more for a
    bf16 plane).  bf16 projections: the same bound, on x on a 2^-5 grid in
    [-1.875, 1.875] and wi_cat, b2 on a 2^-10 grid in [-0.5, 0.5], so that
    every partial sum of ``x . wi_cat + b2[0]`` is exact in float32; there
    the rounding of xp itself moves the plain output by more than 10x the
    bound, so the check tells the two modes apart."""
    rng = np.random.default_rng(16)
    args = _intra_v2_args(rng, 64, dev)
    x = _rand(rng, (N, L, 64), dev).to(plane)
    gru_kernels.reset_launch_counts()
    got = gru_kernels.dprnn_intra_block_v2(x, *args, xp_bf16=False)
    _close(got, gru_kernels.dprnn_intra_block_v2_plain(x, *args, xp_bf16=False))
    xg = on_grid(x.float(), 2.0 ** -5, 1.875).to(plane)
    wi_cat, wh_big, b2 = args[:3]
    gargs = (on_grid(wi_cat, 2.0 ** -10, 0.5), wh_big, on_grid(b2, 2.0 ** -10, 0.5), *args[3:])
    got = gru_kernels.dprnn_intra_block_v2(xg, *gargs)
    ref = gru_kernels.dprnn_intra_block_v2_plain(xg, *gargs)
    _close(got, ref)
    moved = gru_kernels.dprnn_intra_block_v2_plain(xg, *gargs, xp_bf16=False)
    assert (moved.float() - ref.float()).abs().max().item() > 10 * TOL
    assert gru_kernels.launch_counts()["dprnn_intra_block_v2"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("N,L", [
    (30, 40), (7, 48), (200, 8), (896, 48),
    # test_cuda_intra_plan_edges' shapes
    (1, 48), (5, 3), (67, 4), (401, 5), (1001, 40), (13, 1)])
def test_cuda_intra_v2_f32_xp_bit_identical_to_v1(dev, N, L, plane):
    """With float32 input projections intra v2 is the v1 stage: the intra
    kernel reading pack_intra_v2's tensors gives dprnn_intra_block's bits
    on the matching v1 packs, in one launch."""
    rng = np.random.default_rng(18)
    C = 64
    wi2, wh2, b2 = _pack_bidir(_gru(rng, C, C, dev), _gru(rng, C, C, dev))
    wfc = _rand(rng, (2 * C, C), dev, 0.3)
    epi = (_rand(rng, (C,), dev, 0.1), 1.0 + _rand(rng, (C,), dev, 0.5),
           _rand(rng, (C,), dev, 0.1))
    wi_cat, wh_big = gru_kernels.pack_intra_v2(wi2, wh2, wfc)
    x = _rand(rng, (N, L, C), dev).to(plane)
    gru_kernels.reset_launch_counts()
    got = gru_kernels.dprnn_intra_block_v2(x, wi_cat, wh_big, b2, *epi, xp_bf16=False)
    assert gru_kernels.launch_counts()["dprnn_intra_block_v2"] == 1
    assert torch.equal(got, gru_kernels.dprnn_intra_block(x, wi2, wh2, b2, wfc, *epi))


@pytest.mark.cuda
@pytest.mark.parametrize("xp_dtype,plane", [(BF16, torch.float32), (BF16, BF16),
                                            (torch.float32, torch.float32)])
@pytest.mark.parametrize("B,T,Fq", [
    (3, 10, 40), (1, 7, 48), (64, 1, 48),
    # the plan's edges: one row; 1 / 2 rows per warp at the threshold; one
    # and two blocks per SM
    (1, 5, 1), (11, 4, 48), (7, 6, 37), (22, 3, 48), (23, 3, 48)])
def test_cuda_inter_v2_matches_plain(dev, B, T, Fq, xp_dtype, plane):
    rng = np.random.default_rng(17)
    C = 64
    p = _gru(rng, C, C, dev)
    whfc = torch.cat([p["wh"], _rand(rng, (C, C), dev, 0.3)], dim=1)
    epi = (_rand(rng, (C,), dev, 0.1), 1.0 + _rand(rng, (C,), dev, 0.5),
           _rand(rng, (C,), dev, 0.1))
    x = _rand(rng, (B, T, Fq, C), dev).to(plane)
    xp = (x.float() @ p["wi"] + p["bi"]).to(xp_dtype)
    h0 = _rand(rng, (B, Fq, C), dev, 0.2)
    gru_kernels.reset_launch_counts()
    out, hl = gru_kernels.dprnn_inter_block_v2(xp, x, h0, whfc, p["bh"], *epi)
    assert gru_kernels.launch_counts()["dprnn_inter_block_v2"] == 1
    ref, hl_ref = gru_kernels.dprnn_inter_block_v2_plain(xp, x, h0, whfc, p["bh"], *epi)
    _close(out, ref)
    _close(hl, hl_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
def test_cuda_inter_v2_batch_invariant(dev, plane):
    """Row (b, f) of a plane of 64 x 48 rows (2 rows per warp) equals the
    same row run alone and within its batch entry's 48 rows (1 row per
    warp), on the same xp: max-abs 0."""
    rng = np.random.default_rng(22)
    C = 64
    p = _gru(rng, C, C, dev)
    whfc = torch.cat([p["wh"], _rand(rng, (C, C), dev, 0.3)], dim=1)
    epi = (_rand(rng, (C,), dev, 0.1), 1.0 + _rand(rng, (C,), dev, 0.5),
           _rand(rng, (C,), dev, 0.1))
    x = _rand(rng, (64, 9, 48, C), dev).to(plane)
    xp = (x.float() @ p["wi"] + p["bi"]).to(BF16)
    h0 = _rand(rng, (64, 48, C), dev, 0.2)
    out, hl = gru_kernels.dprnn_inter_block_v2(xp, x, h0, whfc, p["bh"], *epi)
    for b, f in ((0, 0), (37, 5), (63, 47)):
        for fs in (slice(f, f + 1), slice(0, 48)):
            o1, h1 = gru_kernels.dprnn_inter_block_v2(
                xp[b:b + 1, :, fs].contiguous(), x[b:b + 1, :, fs].contiguous(),
                h0[b:b + 1, fs].contiguous(), whfc, p["bh"], *epi)
            assert torch.equal(o1[0], out[b, :, fs]) and torch.equal(h1[0], hl[b, fs])


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_other_dtypes(dev):
    """A CUDA plane reaches its kernel or raises: float16 planes and bf16
    weights or hiddens are refused, never cast."""
    rng = np.random.default_rng(18)
    p = _gru(rng, 64, 64, dev)
    x = _rand(rng, (2, 3, 64), dev)
    h0 = _rand(rng, (2, 64), dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gru_kernels.gru_scan(x.half(), h0, p["wi"], p["bi"], p["wh"], p["bh"])
    with pytest.raises(ValueError, match="takes float32"):
        gru_kernels.gru_scan(x.to(BF16), h0.to(BF16), p["wi"], p["bi"], p["wh"], p["bh"])
    with pytest.raises(ValueError, match="takes float32"):
        gru_kernels.gru_scan(x, h0, p["wi"].to(BF16), p["bi"], p["wh"], p["bh"])


@pytest.mark.cuda
@pytest.mark.parametrize("quality", ["fast", "turbo"])
def test_cuda_exact_streaming_bf16_tiers_bit_invariant(dev, monkeypatch, quality):
    """Exact mode of the fast / turbo engines on the card (turbo with the
    v2 inter kernel): the same frames cut three ways give the same bits,
    and the tier's TF32 setting does not outlive the calls."""
    from dpdfnet_tpu_torch import get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    monkeypatch.setenv("DPDFNET_TPU_PALLAS_V2", "1" if quality == "turbo" else "0")
    cfg = get_config("dpdfnet2")
    eng = engine_from_quality(cfg, contract_params(init_params(cfg, seed=0, device=dev)),
                              quality, device=dev)
    frames = (0.1 * np.random.default_rng(19).normal(size=(3, 9, cfg.win_len))).astype(np.float32)
    outs = []
    gru_kernels.reset_launch_counts()
    for cuts in ([9], [1] * 9, [2, 4, 3]):
        st, ys, pos = eng.init_stream_state(batch=3), [], 0
        for n in cuts:
            y, st = eng.process_frames(frames[:, pos:pos + n], st)
            ys.append(y)
            pos += n
        outs.append(np.concatenate(ys, axis=1))
    counts = gru_kernels.launch_counts()
    assert counts["dprnn_inter_block_v2" if quality == "turbo" else "dprnn_inter_block"] > 0
    assert np.isfinite(outs[0]).all()
    for y in outs[1:]:
        np.testing.assert_array_equal(y, outs[0])
    assert not torch.backends.cuda.matmul.allow_tf32


# --------------------------------------------------------------------------- #
# The freq-major layout: relayout_fm and the intra / inter layout modes
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("shape,src,dst", [
    ((4, 10, 40, 64), torch.float32, torch.float32),
    ((4, 10, 48, 64), torch.float32, BF16),
    ((3, 9, 11, 64), BF16, torch.float32),
    ((5, 7, 13, 6), torch.float32, BF16),          # C % 4 != 0: the scalar path
    ((2, 3, 5, 64), BF16, BF16),
])
def test_cuda_relayout_fm_bit_exact(dev, shape, src, dst):
    x = _rand(np.random.default_rng(30), shape, dev).to(src)
    gru_kernels.reset_launch_counts()
    got = gru_kernels.relayout_fm(x, out_dtype=dst)
    assert gru_kernels.launch_counts()["relayout_fm"] == 1
    assert torch.equal(got, gru_kernels.relayout_fm_plain(x, dst))


def _intra_args(rng, dev, C=64):
    wi2, wh2, b2 = _pack_bidir(_gru(rng, C, C, dev), _gru(rng, C, C, dev))
    return (wi2, wh2, b2, _rand(rng, (2 * C, C), dev, 0.3), _rand(rng, (C,), dev, 0.1),
            1.0 + _rand(rng, (C,), dev, 0.5), _rand(rng, (C,), dev, 0.1))


def _inter_args(rng, dev, C=64):
    p = _gru(rng, C, C, dev)
    return (p["wi"], p["bi"], p["wh"], p["bh"], _rand(rng, (C, C), dev, 0.3),
            _rand(rng, (C,), dev, 0.1), 1.0 + _rand(rng, (C,), dev, 0.5),
            _rand(rng, (C,), dev, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
def test_cuda_intra_fm_mode(dev, plane):
    """fm_batch: [Fq, T*B, C] in, [T, Fq, B, C] out, with T, B, Fq all
    different; against the plain version, and bit-identical to the
    row-major mode on the same rows."""
    rng = np.random.default_rng(31)
    B, T, Fq = 5, 3, 40
    args = _intra_args(rng, dev)
    x4 = _rand(rng, (B, T, Fq, 64), dev).to(plane)
    plane_fm = x4.permute(2, 1, 0, 3).reshape(Fq, T * B, 64).contiguous()
    got = gru_kernels.dprnn_intra_block(plane_fm, *args, fm_batch=B)
    assert got.shape == (T, Fq, B, 64)
    _close(got, gru_kernels.dprnn_intra_block_plain(plane_fm, *args, fm_batch=B))
    rows = gru_kernels.dprnn_intra_block(x4.transpose(0, 1).reshape(T * B, Fq, 64)
                                         .contiguous(), *args)
    assert torch.equal(got, rows.reshape(T, B, Fq, 64).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("h_bm", [False, True])
@pytest.mark.parametrize("plane", [torch.float32, BF16])
def test_cuda_inter_fm_modes(dev, plane, h_bm, defer):
    """fm_batch x h_bm x defer against the plain version (the deferred
    bf16 tail rounds the hidden before its fc on both sides, so a flipped
    rounding moves the output by more than one ulp: 3e-2 there, as in
    tests/test_torch_fm.py); the fused modes bit-identical to the
    row-major mode on the same rows, h_bm to the rows' hidden order."""
    rng = np.random.default_rng(32)
    B, T, Fq = 6, 4, 16
    args = _inter_args(rng, dev)
    x4 = _rand(rng, (B, T, Fq, 64), dev).to(plane)
    h4 = _rand(rng, (B, Fq, 64), dev, 0.2)
    x_fm = x4.permute(1, 2, 0, 3).reshape(T, Fq * B, 64).contiguous()
    h0 = h4 if h_bm else h4.transpose(0, 1).reshape(Fq * B, 64).contiguous()
    gru_kernels.reset_launch_counts()
    out, hl = gru_kernels.dprnn_inter_block(x_fm, h0, *args, fm_batch=B, h_bm=h_bm, defer=defer)
    assert gru_kernels.launch_counts()["dprnn_inter_block"] == 1
    assert out.shape == (Fq, T, B, 64) and hl.shape == h0.shape
    ref, hl_ref = gru_kernels.dprnn_inter_block(x_fm.cpu(), h0.cpu(),
                                                *(a.cpu() for a in args), fm_batch=B,
                                                h_bm=h_bm, defer=defer)
    _close(out.cpu(), ref, 3e-2 if defer and plane == BF16 else TOL)
    _close(hl.cpu(), hl_ref)
    if not defer:
        rows, hl_rows = gru_kernels.dprnn_inter_block(x4, h4, *args, defer=False)
        assert torch.equal(out, rows.permute(2, 1, 0, 3))
        assert torch.equal(hl if h_bm else hl.reshape(Fq, B, 64).transpose(0, 1), hl_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
def test_cuda_ablation_specializations_match_plain(dev, plane):
    """Every specialization of both ablation tools against its plain
    version (both intra layouts), 1e-4 beyond one bf16 ulp."""
    from dpdfnet_tpu_torch.tools import inter_step_ablation, intra_step_ablation

    for errs in (intra_step_ablation.check_specializations(rows=40, T=16, dtype=plane,
                                                           log=lambda m: None),
                 inter_step_ablation.check_specializations(rows=40, T=9, dtype=plane,
                                                           log=lambda m: None)):
        assert max(errs.values()) < TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("tool,layout", [("intra", "rows"), ("intra", "tm"), ("inter", "rows")])
def test_cuda_ablation_full_equals_production(dev, tool, layout, plane):
    """Each ablation tool's ``full`` is the production kernel: bit for bit
    ``dprnn_intra_block`` (row-major, and ``fm_batch=rows`` for ``tm``) and
    ``dprnn_inter_block`` (the rows as a [1, T, rows, C] plane), at the
    check shapes and at a ragged one."""
    from dpdfnet_tpu_torch.tools import inter_step_ablation, intra_step_ablation

    mod = intra_step_ablation if tool == "intra" else inter_step_ablation
    for rows, T in ((40, 16 if tool == "intra" else 9), (1001, 5)):
        assert mod.full_matches_production(rows, T, dtype=plane, seed=rows)[layout]


@pytest.mark.cuda
def test_cuda_mode_off_bit_identical_to_record(dev):
    """Every DPRNN / GRU kernel with its layout modes off gives the outputs
    of the committed record (its note names each case's commit)."""
    import json

    from dpdfnet_tpu_torch.tools import mode_off_digest

    record = json.loads(mode_off_digest.RECORD.read_text())
    got = mode_off_digest.kernel_digests(gru_kernels)
    assert mode_off_digest.compare(got, record, mode_off_digest.toolchain()) == []


# --------------------------------------------------------------------------- #
# The warp-walk v1 DPRNN kernels (csrc/gru64_warp.cuh): main-path shapes,
# plan edges, batch invariance and run-to-run repeatability
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("B,T,Fq", [(8, 112, 48), (64, 112, 48), (64, 1, 48), (64, 112, 40)])
def test_cuda_inter_main_path_shapes(dev, B, T, Fq, plane):
    """B=8, B=64 x 112 (Fq 48 and 40) and T=1 x 64 streams against the plain
    version, with one launch per call."""
    rng = np.random.default_rng(40)
    args = _inter_args(rng, dev)
    x = _rand(rng, (B, T, Fq, 64), dev).to(plane)
    h0 = _rand(rng, (B, Fq, 64), dev, 0.2)
    gru_kernels.reset_launch_counts()
    out, hl = gru_kernels.dprnn_inter_block(x, h0, *args, defer=False)
    assert gru_kernels.launch_counts()["dprnn_inter_block"] == 1
    ref, hl_ref = gru_kernels.dprnn_inter_block_plain(x, h0, *args)
    _close(out, ref)
    _close(hl, hl_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("N,Fq", [(896, 48), (7168, 48), (64, 48), (7168, 40)])
def test_cuda_intra_main_path_shapes(dev, N, Fq, plane):
    """B=8 (896 rows), B=64 x 112 (7168 rows, Fq 48 and 40) and T=1 x 64
    streams against the plain version, with one launch per call."""
    rng = np.random.default_rng(41)
    args = _intra_args(rng, dev)
    x = _rand(rng, (N, Fq, 64), dev).to(plane)
    gru_kernels.reset_launch_counts()
    got = gru_kernels.dprnn_intra_block(x, *args)
    assert gru_kernels.launch_counts()["dprnn_intra_block"] == 1
    _close(got, gru_kernels.dprnn_intra_block_plain(x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Fq", [
    # one row; fewer rows than SMs; a ragged last warp (2 rows per warp,
    # odd N); more rows than one wave of blocks; T below and at the chunk
    (1, 5, 1), (3, 2, 7), (133, 3, 9), (150, 9, 21), (1, 1, 3), (2, 4, 48)])
def test_cuda_inter_plan_edges(dev, B, T, Fq):
    rng = np.random.default_rng(42)
    args = _inter_args(rng, dev)
    x = _rand(rng, (B, T, Fq, 64), dev)
    h0 = _rand(rng, (B, Fq, 64), dev, 0.2)
    out, hl = gru_kernels.dprnn_inter_block(x, h0, *args, defer=False)
    ref, hl_ref = gru_kernels.dprnn_inter_block_plain(x, h0, *args)
    _close(out, ref)
    _close(hl, hl_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N,Fq", [
    # one row; rows below one cluster per SM pair; a ragged last tile and
    # warp; several rounds of tiles; Fq below, at and off the chunk
    (1, 48), (5, 3), (67, 4), (401, 5), (1001, 40), (13, 1)])
def test_cuda_intra_plan_edges(dev, N, Fq):
    rng = np.random.default_rng(43)
    args = _intra_args(rng, dev)
    x = _rand(rng, (N, Fq, 64), dev)
    _close(gru_kernels.dprnn_intra_block(x, *args), gru_kernels.dprnn_intra_block_plain(x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
def test_cuda_v1_dprnn_batch_invariant(dev, plane):
    """A row alone gives the bits it has in a batch of 64 x 112 (another
    plan: rows per warp, warps, TS, tiles): max-abs 0, for inter (rows
    (b, f)) and intra (rows b * T + t)."""
    rng = np.random.default_rng(44)
    ea, ia = _inter_args(rng, dev), _intra_args(rng, dev)
    x = _rand(rng, (64, 12, 48, 64), dev).to(plane)
    h0 = _rand(rng, (64, 48, 64), dev, 0.2)
    out, hl = gru_kernels.dprnn_inter_block(x, h0, *ea, defer=False)
    rows = x.reshape(64 * 12, 48, 64)
    intra = gru_kernels.dprnn_intra_block(rows, *ia)
    for b, f in ((0, 0), (37, 5), (63, 47)):
        for fs in (slice(f, f + 1), slice(0, 48)):
            o1, h1 = gru_kernels.dprnn_inter_block(x[b:b + 1, :, fs].contiguous(),
                                                   h0[b:b + 1, fs].contiguous(), *ea, defer=False)
            assert torch.equal(o1[0], out[b, :, fs]) and torch.equal(h1[0], hl[b, fs])
    for n in (0, 100, 767):
        assert torch.equal(gru_kernels.dprnn_intra_block(rows[n:n + 1].contiguous(), *ia)[0],
                           intra[n])
    assert torch.equal(gru_kernels.dprnn_intra_block(rows[:70].contiguous(), *ia), intra[:70])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["inter", "intra", "gru_bidir", "stack", "intra_ablation",
                                    "inter_ablation"])
def test_cuda_walk_kernels_repeat_bit_exact(dev, kernel):
    """The same seeded input 50 times in one process, every other call
    after NaN has gone through the caching allocator and another walk
    kernel through shared memory: the same bits every time (a race or a
    read of an unwritten buffer would show here).  inter, intra,
    gru_bidir and the ablation kernels' ``full`` run the warp walk of
    gru64_warp.cuh, the stack its own walk with a named barrier per
    direction."""
    rng = np.random.default_rng(45)
    ia = _intra_args(rng, dev)
    if kernel == "intra_ablation":
        from dpdfnet_tpu_torch.tools import intra_step_ablation as abl

        x, w = abl.make_inputs(30, 40, 64, "cuda", dtype=torch.float32, seed=45)
        call = lambda: (abl.run_intra("full", x, *w),)  # noqa: E731
    elif kernel == "inter_ablation":
        from dpdfnet_tpu_torch.tools import inter_step_ablation as abl

        x, h0, wp, bp, tail = abl.make_inputs(96, 4, 64, "cuda", dtype=torch.float32, seed=45)
        call = lambda: abl.run_inter("full", x, h0, *abl.unpack_wp(wp, bp), *tail)  # noqa: E731
    elif kernel == "stack":
        stacked = _stacked(rng, 3, 64, dev)
        x, h0 = _rand(rng, (5, 3, 40, 64), dev), _rand(rng, (3, 5, 40, 64), dev, 0.2)
        call = lambda: gru_kernels.dprnn_stack(x, h0, stacked)  # noqa: E731
    elif kernel == "inter":
        ea = _inter_args(rng, dev)
        x, h0 = _rand(rng, (6, 4, 16, 64), dev), _rand(rng, (6, 16, 64), dev, 0.2)
        x_fm = x.permute(1, 2, 0, 3).reshape(4, 96, 64).contiguous()
        h_fm = h0.transpose(0, 1).reshape(96, 64).contiguous()
        call = lambda: gru_kernels.dprnn_inter_block(x_fm, h_fm, *ea, fm_batch=6, defer=False)  # noqa: E731
    elif kernel == "intra":
        x = _rand(rng, (30, 40, 64), dev)
        call = lambda: (gru_kernels.dprnn_intra_block(x, *ia),)  # noqa: E731
    else:
        x = _rand(rng, (30, 40, 64), dev)
        call = lambda: gru_kernels.gru_bidir(x, *ia[:3])  # noqa: E731
    other = _rand(rng, (50, 48, 64), dev)
    first = [t.clone() for t in call()]
    for i in range(50):
        if i % 2:
            junk = torch.full((1 << 22,), float("nan"), device=dev)
            del junk
            gru_kernels.dprnn_intra_block(other, *ia)
        for a, b in zip(call(), first):
            assert torch.equal(a, b), f"call {i} differs by {(a - b).abs().max().item():.3e}"


@pytest.mark.cuda
def test_cuda_exact_streaming_states_match_cpu(dev):
    """Exact streaming of the flagship on speech-shaped input, card against
    CPU (``highest``): the output and every carried state leaf within
    rel_rms 1e-3.  The recurrent kernels carry their hiddens over every
    hop, so a gate approximation that stays within the kernel tolerance
    on random inputs but drifts on a real signal shows here (a fast
    exp / division in the DPRNN gates put the erb hiddens at rel_rms 0.9)."""
    from dpdfnet_tpu_torch import Engine, get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.quality import speechlike_test_signal
    from dpdfnet_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("dpdfnet8_48khz_hr")
    params = contract_params(init_params(cfg, seed=0, device=dev))
    sr = cfg.sample_rate
    sp = speechlike_test_signal(1.0, sr, seed=5, batch=2)
    frames = sp[:, sr // 4 + np.arange(16)[:, None] * cfg.hop + np.arange(cfg.win_len)[None, :]]
    outs = {}
    for where, p in (("cuda", params), ("cpu", tree_map(lambda _, t: t.cpu(), params))):
        eng = Engine(cfg, p, device=where)
        outs[where] = eng.process_frames(frames, eng.init_stream_state(batch=2))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)))

    (y, st), (ref, st_ref) = outs["cuda"], outs["cpu"]
    assert rel(y, ref) < 1e-3
    ref_leaves = dict(tree_leaves(st_ref))
    worst = max((rel(v.float().cpu().numpy(), ref_leaves[k].float().numpy()), k)
                for k, v in tree_leaves(st))
    assert worst[0] < 1e-3, worst


# --------------------------------------------------------------------------- #
# gru_bidir on the warp walk, and the DPRNN stack: main-path shapes, plan
# edges, batch invariance, and the stack's bits against the per-stage chain
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("N,L", [(896, 48), (7168, 48), (7168, 40), (64, 48)])
def test_cuda_gru_bidir_main_path_shapes(dev, N, L, plane):
    """B=8 (896 rows), B=64 x 112 (7168 rows, the df and erb widths) and
    T=1 x 64 streams against the plain version, with one launch per call."""
    rng = np.random.default_rng(50)
    w = _pack_bidir(_gru(rng, 64, 64, dev), _gru(rng, 64, 64, dev))
    x = _rand(rng, (N, L, 64), dev).to(plane)
    gru_kernels.reset_launch_counts()
    got = gru_kernels.gru_bidir(x, *w)
    assert gru_kernels.launch_counts()["gru_bidir"] == 1
    for a, b in zip(got, gru_kernels.gru_bidir_plain(x, *w)):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,L", [
    # one row; rows below one CTA pair per SM pair; a ragged last tile and
    # warp; several rounds of tiles; L below, at and off the chunk
    (1, 48), (5, 3), (67, 4), (401, 5), (1001, 40), (13, 1)])
def test_cuda_gru_bidir_plan_edges(dev, N, L):
    rng = np.random.default_rng(51)
    w = _pack_bidir(_gru(rng, 64, 64, dev), _gru(rng, 64, 64, dev))
    x = _rand(rng, (N, L, 64), dev)
    for a, b in zip(gru_kernels.gru_bidir(x, *w), gru_kernels.gru_bidir_plain(x, *w)):
        _close(a, b)


def _stack_blocks(stacked, K):
    """Each block's dprnn_intra_block and dprnn_inter_block weights out of
    a pack_stack dict."""
    s = stacked
    return [((s["wi2"][k], s["wh2"][k], s["b2"][k], s["wfc_i"][k], s["bfc_i"][k, 0],
              s["g_i"][k, 0], s["bln_i"][k, 0]),
             (s["wi_t"][k], s["b2_t"][k, 0], s["wh_t"][k], s["b2_t"][k, 1], s["wfc_t"][k],
              s["bfc_t"][k, 0], s["g_t"][k, 0], s["bln_t"][k, 0])) for k in range(K)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Fq,K", [(64, 1, 48, 8), (3, 4, 40, 3), (1, 2, 13, 1), (5, 8, 48, 2)])
def test_cuda_stack_bit_identical_to_per_stage_chain(dev, B, T, Fq, K):
    """On float32 planes the stack's out and h_last equal, bit for bit, K
    applications of dprnn_intra_block + dprnn_inter_block frame by frame
    (the JAX stack kernel's definition), and the model's block-by-block
    order over all T frames."""
    rng = np.random.default_rng(52)
    stacked = _stacked(rng, K, 64, dev)
    blocks = _stack_blocks(stacked, K)
    x = _rand(rng, (B, T, Fq, 64), dev)
    h0 = _rand(rng, (K, B, Fq, 64), dev, 0.5)
    out, hl = gru_kernels.dprnn_stack(x, h0, stacked)
    hs, frames = [h0[k] for k in range(K)], []
    for t in range(T):
        cur = x[:, t:t + 1].contiguous()
        for k, (ia, ea) in enumerate(blocks):
            cur = gru_kernels.dprnn_intra_block(cur.reshape(B, Fq, 64), *ia).reshape(B, 1, Fq, 64)
            cur, hs[k] = gru_kernels.dprnn_inter_block(cur, hs[k], *ea, defer=False)
        frames.append(cur)
    ref = torch.cat(frames, dim=1)
    assert torch.equal(out, ref), f"out differs by {(out - ref).abs().max().item():.3e}"
    assert torch.equal(hl, torch.stack(hs)), \
        f"h_last differs by {(hl - torch.stack(hs)).abs().max().item():.3e}"
    cur, hb = x, []
    for k, (ia, ea) in enumerate(blocks):
        cur = gru_kernels.dprnn_intra_block(cur.reshape(B * T, Fq, 64), *ia).reshape(x.shape)
        cur, h = gru_kernels.dprnn_inter_block(cur, h0[k], *ea, defer=False)
        hb.append(h)
    assert torch.equal(out, cur) and torch.equal(hl, torch.stack(hb))


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
@pytest.mark.parametrize("B,T,Fq", [(64, 1, 48), (64, 1, 40), (64, 8, 48), (8, 112, 48),
                                    (1, 1, 48), (256, 1, 48)])
def test_cuda_stack_main_path_shapes(dev, B, T, Fq, plane):
    """One exact hop of 64 streams (both branches), a throughput-mode call,
    the offline shape and the pool's edges, K = 8, against the plain
    version, with one launch per call.  Weights at the model's scale
    (fan-in ** -0.5): at _stacked's default 0.3 the gates saturate and the
    plane grows block by block, so the f32 summation-order difference to
    the plain version grows about 2.5x per block (5e-6 at K = 1, 5e-4 at
    K = 8), in the per-stage chain as in the stack, whose bits are the
    chain's."""
    rng = np.random.default_rng(53)
    stacked = _stacked(rng, 8, 64, dev, scale=64 ** -0.5)
    x = _rand(rng, (B, T, Fq, 64), dev).to(plane)
    h0 = _rand(rng, (8, B, Fq, 64), dev, 0.5)
    gru_kernels.reset_launch_counts()
    out, hl = gru_kernels.dprnn_stack(x, h0, stacked)
    assert gru_kernels.launch_counts()["dprnn_stack"] == 1
    ref, hl_ref = gru_kernels.dprnn_stack_plain(x, h0, stacked)
    _close(out, ref)
    _close(hl, hl_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [torch.float32, BF16])
def test_cuda_gru_bidir_and_stack_batch_invariant(dev, plane):
    """A row alone gives the bits it has in a batch (gru_bidir: rows of
    another plan; the stack: a stream alone, and two frames split over two
    calls with the carried hidden), max-abs 0."""
    rng = np.random.default_rng(54)
    w = _pack_bidir(_gru(rng, 64, 64, dev), _gru(rng, 64, 64, dev))
    x = _rand(rng, (64 * 12, 48, 64), dev).to(plane)
    yf, yb = gru_kernels.gru_bidir(x, *w)
    for n in (0, 100, 767):
        f1, b1 = gru_kernels.gru_bidir(x[n:n + 1].contiguous(), *w)
        assert torch.equal(f1[0], yf[n]) and torch.equal(b1[0], yb[n])
    f70, b70 = gru_kernels.gru_bidir(x[:70].contiguous(), *w)
    assert torch.equal(f70, yf[:70]) and torch.equal(b70, yb[:70])
    stacked = _stacked(rng, 2, 64, dev)
    xs = _rand(rng, (9, 2, 48, 64), dev).to(plane)
    h0 = _rand(rng, (2, 9, 48, 64), dev, 0.5)
    out, hl = gru_kernels.dprnn_stack(xs, h0, stacked)
    for b in (0, 4, 8):
        o1, h1 = gru_kernels.dprnn_stack(xs[b:b + 1].contiguous(), h0[:, b:b + 1].contiguous(),
                                         stacked)
        assert torch.equal(o1[0], out[b]) and torch.equal(h1[:, 0], hl[:, b])
    o_a, h_a = gru_kernels.dprnn_stack(xs[:, :1].contiguous(), h0, stacked)
    o_b, h_b = gru_kernels.dprnn_stack(xs[:, 1:].contiguous(), h_a, stacked)
    assert torch.equal(torch.cat([o_a, o_b], dim=1), out) and torch.equal(h_b, hl)


@pytest.mark.cuda
def test_cuda_api_enhance_equals_engine_path(dev, tmp_path, monkeypatch):
    """``api.enhance`` by model name on the card (weights from an npz in a
    temporary model directory, downloads refused) equals
    ``Engine.enhance_waveforms`` of the engine it cached, stepped or not."""
    from dpdfnet_tpu_torch import api, zoo
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.utils.serialization import save_params

    def no_download(url, destination):
        raise AssertionError(f"download attempted: {url}")

    cfg = get_config("dpdfnet2")
    save_params(tmp_path / "dpdfnet2.params.npz",
                contract_params(init_params(cfg, seed=0, device=dev)))
    monkeypatch.setenv("DPDFNET_TPU_MODEL_DIR", str(tmp_path))
    monkeypatch.setattr(zoo, "_download_one", no_download)
    api.clear_engine_cache()
    try:
        rng = np.random.default_rng(3)
        x = (0.1 * rng.normal(size=int(1.5 * cfg.sample_rate))).astype(np.float32)
        y = api.enhance(x, cfg.sample_rate, model="dpdfnet2")
        eng = api._get_engine("dpdfnet2")
        assert eng.device.type == "cuda"
        np.testing.assert_array_equal(y, eng.enhance_waveforms(x))
        events = []
        stepped = api.enhance(x, cfg.sample_rate, model="dpdfnet2",
                              progress_callback=lambda d, t: events.append((d, t)))
        np.testing.assert_array_equal(stepped, y)
        T = events[0][1]
        assert events == [(0, T)] + [(min((i + 1) * eng.seg_frames, T), T)
                                     for i in range(-(-T // eng.seg_frames))]
    finally:
        api.clear_engine_cache()


@pytest.mark.cuda
def test_cuda_train_step_launches_no_kernel_and_converts(dev, tmp_path):
    """Two Adam steps on the card run the plain versions only (no launch),
    lower the loss and leave the filterbanks alone; an engine on the
    trained weights launches the kernels again; a synthetic ``.pth``
    converts on the card to the same weights, bit for bit."""
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models import convert
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.runtime.engine import Engine
    from dpdfnet_tpu_torch.tools.synth_checkpoint import save_checkpoint
    from dpdfnet_tpu_torch.train import make_train_step, trainable_parameters
    from dpdfnet_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("dpdfnet2")
    p = contract_params(init_params(cfg, seed=0, device=dev))
    save_checkpoint(tmp_path / "m.pth", p, cfg)
    conv = dict(tree_leaves(convert.load_params(tmp_path / "m.pth", cfg, device=dev)))
    assert all(conv[k].is_cuda and torch.equal(conv[k], v) for k, v in tree_leaves(p))
    rng = np.random.default_rng(4)
    clean = torch.tensor(0.1 * rng.normal(size=(2, 4000)), dtype=torch.float32, device=dev)
    noisy = clean + 0.05 * torch.randn(clean.shape, generator=torch.Generator(dev).manual_seed(1),
                                       device=dev)
    fb = p["erb_fb"].clone()
    step = make_train_step(cfg, torch.optim.Adam(trainable_parameters(p), lr=1e-3))
    gru_kernels.reset_launch_counts()
    losses = [float(step(p, noisy, clean)[0]) for _ in range(2)]
    assert all(v == 0 for v in gru_kernels.launch_counts().values())
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert torch.equal(p["erb_fb"], fb)
    eng = Engine(cfg, tree_map(lambda _, x: x.detach(), p), device=dev)
    gru_kernels.reset_launch_counts()
    with torch.no_grad():
        y = eng.enhance_waveforms(noisy.cpu().numpy())
    assert np.isfinite(y).all() and gru_kernels.launch_counts()["gru_scan"] > 0


# --------------------------------------------------------------------------- #
# The captured streaming programs (CUDA graphs) and the exported step
# --------------------------------------------------------------------------- #

def _graph_engine(dev, quality="highest"):
    from dpdfnet_tpu_torch import get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    cfg = get_config("dpdfnet2")
    return engine_from_quality(cfg, contract_params(init_params(cfg, seed=0, device=dev)),
                               quality, device=dev)


def _eager_exact(eng, frames):
    """Front, forward_spec and back once per frame, no graph."""
    from dpdfnet_tpu_torch.runtime.engine import _math_mode

    st = eng.init_stream_state(batch=frames.shape[0])
    x = torch.from_numpy(frames).to(eng.device)
    step, ys = eng._stream_step("exact"), []
    with _math_mode(eng.precision), torch.no_grad():
        for t in range(frames.shape[1]):
            y, st = step(x[:, t:t + 1].contiguous(), st)
            ys.append(y)
    return torch.cat(ys, dim=1).cpu().numpy()


@pytest.mark.cuda
def test_cuda_stream_graph_equals_eager_and_counts_replays(dev):
    """Exact streaming through the captured graph: bit for bit the eager
    per-frame loop and bit-invariant to chunking.  The wrappers count only
    the launches of the first hop, which runs eagerly before the capture;
    every later hop is one graph replay, and a traced replayed hop runs
    16 / 16 / 5 ... kernels (dpdfnet2: 4 / 4 / 5)."""
    from torch.profiler import ProfilerActivity, profile

    from dpdfnet_tpu_torch.runtime.profile import kernel_launches

    eng = _graph_engine(dev)
    B, T = 4, 12
    blocks = 2 * eng.cfg.dprnn_blocks
    per_hop = {"dprnn_intra_block": blocks, "dprnn_inter_block": blocks, "gru_scan": 5}
    frames = (0.1 * np.random.default_rng(21).normal(size=(B, T, eng.cfg.win_len))
              ).astype(np.float32)
    ref = _eager_exact(eng, frames)
    outs = []
    for cuts in ([T], [1] * T, [5, 3, 4]):
        gru_kernels.reset_launch_counts()
        captured, replays = len(eng._graphs), eng.graph_replays
        st, ys, pos = eng.init_stream_state(batch=B), [], 0
        for n in cuts:
            y, st = eng.process_frames(frames[:, pos:pos + n], st)
            ys.append(y)
            pos += n
        torch.cuda.synchronize()
        eager = len(eng._graphs) - captured
        counts = gru_kernels.launch_counts()
        assert counts == {**dict.fromkeys(counts, 0),
                          **{k: v * eager for k, v in per_hop.items()}}
        assert eng.graph_replays - replays == T - eager
        outs.append(np.concatenate(ys, axis=1))
    assert len(eng._graphs) == 1
    for y in outs:
        np.testing.assert_array_equal(y, ref)
    gru_kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.process_frames(frames[:, :3], eng.init_stream_state(batch=B))
        torch.cuda.synchronize()
    traced = kernel_launches(ev.name for ev in prof.events()
                             if ev.device_type == torch.autograd.DeviceType.CUDA)
    assert traced == {"dprnn_intra_kernel": 3 * blocks, "dprnn_inter_kernel": 3 * blocks,
                      "gru_recur_cluster_kernel": 15}
    assert not any(gru_kernels.launch_counts().values())


@pytest.mark.cuda
def test_cuda_stream_graph_threads_sharing_an_engine(dev):
    """Two threads that each drive a StreamEnhancer on one engine, hop by
    hop at once, each get their single-threaded output bit for bit (the
    engine's lock serialises the graph calls; a capture in one thread may
    overlap the other's frame upload, which thread-local capture allows)."""
    import threading

    from dpdfnet_tpu_torch import StreamEnhancer

    eng = _graph_engine(dev)
    hop = eng.cfg.hop
    rng = np.random.default_rng(24)
    xs = [(0.1 * rng.normal(size=60 * hop)).astype(np.float32) for _ in range(2)]
    chunk = 2 * hop + 5

    def run(x):
        se = StreamEnhancer(engine=eng)
        return np.concatenate([se.process(x[i:i + chunk]) for i in range(0, len(x), chunk)])

    got, errors = {}, []

    def worker(k):
        try:
            got[k] = run(xs[k])
        except Exception as exc:                           # reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k in range(2):
        np.testing.assert_array_equal(got[k], run(xs[k]))


@pytest.mark.cuda
def test_cuda_stream_graph_shared_engine_streams_are_independent(dev):
    """Two StreamEnhancers and a pool on one engine, interleaved call by
    call, each equal to its own run alone."""
    from dpdfnet_tpu_torch import MultiStreamEnhancer, StreamEnhancer

    eng = _graph_engine(dev)
    hop = eng.cfg.hop
    rng = np.random.default_rng(22)
    xs = [(0.1 * rng.normal(size=40 * hop)).astype(np.float32) for _ in range(4)]
    chunk = 3 * hop + 7

    def alone(x):
        se = StreamEnhancer(engine=eng)
        return np.concatenate([se.process(x[i:i + chunk]) for i in range(0, len(x), chunk)])

    refs = [alone(x) for x in xs[:2]]
    pool_alone = MultiStreamEnhancer(capacity=4, engine=eng)
    sids = [pool_alone.open() for _ in range(2)]
    pool_ref = {s: [] for s in sids}
    for i in range(0, len(xs[2]), chunk):
        for s, y in pool_alone.process_many({sids[0]: xs[2][i:i + chunk],
                                             sids[1]: xs[3][i:i + chunk]}).items():
            pool_ref[s].append(y)

    a, b = StreamEnhancer(engine=eng), StreamEnhancer(engine=eng)
    pool = MultiStreamEnhancer(capacity=4, engine=eng)
    psids = [pool.open() for _ in range(2)]
    got = {"a": [], "b": [], **{s: [] for s in psids}}
    for i in range(0, len(xs[0]), chunk):
        got["a"].append(a.process(xs[0][i:i + chunk]))
        for s, y in pool.process_many({psids[0]: xs[2][i:i + chunk],
                                       psids[1]: xs[3][i:i + chunk]}).items():
            got[s].append(y)
        got["b"].append(b.process(xs[1][i:i + chunk]))
    np.testing.assert_array_equal(np.concatenate(got["a"]), refs[0])
    np.testing.assert_array_equal(np.concatenate(got["b"]), refs[1])
    for s, r in zip(psids, sids):
        np.testing.assert_array_equal(np.concatenate(got[s]), np.concatenate(pool_ref[r]))


@pytest.mark.cuda
def test_cuda_spec_program_and_exported_step_launch_the_kernels(dev, tmp_path):
    """The spec program replays per frame; the exported step on the card
    holds the kernel ops and launches the kernels, within 1e-5 of it."""
    from dpdfnet_tpu_torch import export as ex
    from dpdfnet_tpu_torch.models.params import contract_params, init_params

    eng = _graph_engine(dev, "high")
    cfg = eng.cfg
    rng = np.random.default_rng(23)
    spec = torch.tensor(0.1 * rng.normal(size=(1, 10, cfg.freq_bins, 2)), dtype=torch.float32,
                        device=dev)
    ref, _ = eng._stream_spec_fn(1, 10)(spec, eng.init_stream_state(batch=1))
    path = ex.export_stream(contract_params(init_params(cfg, seed=0, device=dev)), cfg,
                            tmp_path / "m.stream.pt2", device=dev)
    loaded = ex.load_exported(path)
    targets = {str(n.target) for n in loaded.program.graph.nodes if n.op == "call_function"}
    assert {"dpdfnet.dprnn_intra_block.default", "dpdfnet.dprnn_inter_block.default",
            "dpdfnet.gru_scan.default"} <= targets
    flat = torch.from_numpy(ex.build_initial_flat_state(loaded.meta))[None].to(dev)
    gru_kernels.reset_launch_counts()
    outs = []
    for t in range(10):
        o, flat = loaded.call(spec[:, t:t + 1], flat)
        outs.append(o)
    torch.cuda.synchronize()
    assert gru_kernels.launch_counts()["gru_scan"] == 5 * 10
    assert (torch.cat(outs, dim=1) - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("quality", ["highest", "turbo"])
def test_cuda_folded_plane_matches_unfolded(dev, quality):
    """chip_smoke phase 20's parity on dpdfnet2_48khz_hr: a folded tree
    (``fuse_separable``, ``fold_hr_tail``, ``pack_dprnn_bidir``) against
    the engine's default, unfolded one, offline and exact streaming,
    max-abs 1e-5 in highest and rel_rms 1e-3 in turbo; the folded engine
    launches the same kernels per segment."""
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models.fuse import fold_hr_tail, fuse_separable, pack_dprnn_bidir
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    cfg = get_config("dpdfnet2_48khz_hr")
    params = contract_params(init_params(cfg, seed=0, device=dev))
    tree = pack_dprnn_bidir(fold_hr_tail(fuse_separable(params, cfg), cfg), cfg)
    folded = engine_from_quality(cfg, tree, quality, device=dev, fuse=False)
    unfolded = engine_from_quality(cfg, params, quality, device=dev)
    assert "erb_conv0_folded" in folded.params["enc"]
    assert "erb_conv0_folded" not in unfolded.params["enc"]
    rng = np.random.default_rng(20)
    wav = (0.1 * rng.normal(size=(3, cfg.sample_rate))).astype(np.float32)
    frames = (0.05 * rng.normal(size=(4, 12, cfg.win_len))).astype(np.float32)
    with torch.no_grad():
        gru_kernels.reset_launch_counts()
        yf = folded.enhance_waveforms(wav)
        counts = gru_kernels.launch_counts()
        yu = unfolded.enhance_waveforms(wav)
        sf, _ = folded.process_frames(frames, folded.init_stream_state(batch=4))
        su, _ = unfolded.process_frames(frames, unfolded.init_stream_state(batch=4))
    assert counts["dprnn_intra_block"] % (2 * cfg.dprnn_blocks) == 0
    assert counts["dprnn_inter_block"] == counts["dprnn_intra_block"]
    for got, ref in ((yf, yu), (sf, su)):
        assert np.isfinite(got).all()
        if quality == "highest":
            assert np.abs(got - ref).max() <= 1e-5
        else:
            assert np.sqrt(np.mean((got - ref) ** 2)) <= 1e-3 * np.sqrt(np.mean(ref ** 2))


@pytest.mark.cuda
def test_cuda_engine_records_its_graph_spans(dev):
    """On a card the pool's live call records the graph spans: the first
    call an ``engine.capture`` inside ``engine.replay``, the next a replay
    alone, each between ``engine.state_in`` and ``engine.state_out``; the
    byte counters count the frames up and the output back.  Under a
    profiler the program's spans reach the device's timeline only as
    annotations, never as operations."""
    from torch.profiler import ProfilerActivity, profile

    from dpdfnet_tpu_torch import MultiStreamEnhancer
    from dpdfnet_tpu_torch.runtime import telemetry

    eng = _graph_engine(dev)
    cfg = eng.cfg
    pool = MultiStreamEnhancer(capacity=2, engine=eng)
    for _ in range(2):
        pool.open()
    rng = np.random.default_rng(25)

    def hop():
        return {s: (0.1 * rng.normal(size=cfg.hop)).astype(np.float32) for s in range(2)}

    pool.process_many({s: np.zeros(cfg.win_len - cfg.hop, np.float32) for s in range(2)})
    telemetry.reset()
    with telemetry.recording():
        pool.process_many(hop())                # captures the B=2, T=1 graph
        pool.process_many(hop())                # replays it
    recs = telemetry.spans()
    by_id = {s.id: s for s in recs}
    calls = sorted({s.call for s in recs})
    assert len(calls) == 2
    live = {"pool.process_many", "pool.stage", "pool.frame", "engine.process_frames",
            "engine.upload", "engine.state_in", "engine.replay", "engine.state_out",
            "engine.fetch", "pool.overlap_add"}
    first = [s for s in recs if s.call == calls[0]]
    second = [s for s in recs if s.call == calls[1]]
    assert {s.name for s in first} == live | {"engine.capture"}
    assert {s.name for s in second} == live
    for s in recs:
        if s.name in ("engine.state_in", "engine.replay", "engine.state_out"):
            assert by_id[s.parent].name == "engine.process_frames"
            assert s.card == eng.device.index
        if s.name == "engine.capture":
            assert by_id[s.parent].name == "engine.replay"
    frame_bytes = 2 * cfg.win_len * 4
    assert telemetry.counters() == {"engine.h2d_bytes": 2 * frame_bytes,
                                    "engine.d2h_bytes": 2 * frame_bytes,
                                    "pool.stage_lengths": 2}

    telemetry.reset()
    wav = (0.1 * rng.normal(size=(2, cfg.sample_rate))).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pool.process_many(hop())
        eng.enhance_waveforms(wav)
        torch.cuda.synchronize()
    names = set(telemetry.snapshot()["spans"])
    assert {"engine.enhance_waveforms", "engine.launch", "engine.replay"} <= names
    cuda = torch.autograd.DeviceType.CUDA
    mirrors = [ev for ev in prof.events() if ev.device_type == cuda and ev.name in names]
    assert all(getattr(ev, "is_user_annotation", False) for ev in mirrors), \
        sorted({ev.name for ev in mirrors})
    counts = telemetry.counters()
    S_pad = eng.bucket_len(wav.shape[1])
    assert counts["engine.h2d_bytes"] == frame_bytes + 2 * S_pad * 4
    # two rows of S_pad - win_len samples (the frames' span less the alignment)
    assert counts["engine.d2h_bytes"] == frame_bytes + 2 * (S_pad - cfg.win_len) * 4
    n_seg = ((S_pad + cfg.win_len) // cfg.hop + 1) // eng.seg_frames
    assert counts["engine.row_segments"] == counts["engine.row_segments_full"] == 2 * n_seg
    telemetry.reset()


@pytest.mark.cuda
def test_cuda_offline_rows_drop_out_as_their_lengths_end(dev):
    """An unsorted batch of mixed lengths on dpdfnet8_48khz_hr at
    ``seg_frames=16`` (an empty row, one ending on a segment's last valid
    sample, the longest, two in between): each row within 1e-4 of that
    row enhanced alone at its own length and zero past it, the
    counters exact, and the row order uploaded once."""
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.runtime import telemetry
    from dpdfnet_tpu_torch.runtime.engine import Engine

    cfg = get_config("dpdfnet8_48khz_hr")
    eng = Engine(cfg, contract_params(init_params(cfg, seed=0, device=dev)), seg_frames=16,
                 bucket_s=0.0, device=dev)
    seg = 16 * cfg.hop
    lengths = np.array([seg, 0, seg - cfg.hop - 2 * cfg.win_len, 4 * seg, 2 * seg + 7])
    need = [int(eng._bucket_segments(n)) if n else 0 for n in lengths]
    assert need[2] == 1 and max(need) == need[3]
    rng = np.random.default_rng(21)
    wav = np.zeros((len(lengths), int(lengths.max())), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = 0.1 * rng.normal(size=n)
    telemetry.reset()
    with telemetry.recording():
        got = eng.enhance_waveforms(wav, lengths=lengths)
    counts = telemetry.counters()
    telemetry.reset()
    assert counts["engine.row_segments"] == sum(need)
    assert counts["engine.row_segments_full"] == len(lengths) * max(need)
    S_pad = eng.bucket_len(wav.shape[1])
    assert counts["engine.h2d_bytes"] == len(lengths) * (S_pad * 4 + 8)
    for i, n in enumerate(lengths):
        assert np.all(got[i, n:] == 0.0)
        if n:
            alone = eng.enhance_waveforms(wav[i, :n])
            assert float(np.abs(alone).max()) > 0
            assert float(np.abs(got[i, :n] - alone).max()) < TOL
