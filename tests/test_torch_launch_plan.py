"""The launch plans of the warp walks, the cluster GRU scan and the DPRNN
stack.

``gru_kernels.inter_v2_plan``, ``inter_v1_plan``, ``intra_plan``,
``gru_bidir_plan``, ``stack_plan`` and ``gru_scan_plan`` are pure Python:
the wrappers hand their numbers to ``csrc/dprnn_inter_v2.cu``,
``csrc/dprnn_inter.cu``, ``csrc/dprnn_intra.cu``, ``csrc/gru_bidir.cu``,
``csrc/dprnn_stack.cu`` and ``csrc/gru_scan.cu``, whose row indexing the
plans' ``rows`` (``positions``, ``walk_columns``) methods state.
Here every plan covers every row (and, for the scan, every hidden unit)
exactly once, stays within the limits it states, and fills the card as its
docstring says.  Shapes: the plans' edges (N = 1, just below, at and above
a multiple of the rows per warp or cluster, and of the thresholds in SMs),
the main path's N = 320 / 384 (B=8) and 2560 / 3072 (B=64), an odd 600;
H = 32, 64, 96 (a cluster of 3) and 256; SM counts of 132 (H100 SXM) and 8.
The v1 DPRNN plans at N = 1, 64 (one exact hop's intra rows), 96, 384
(inter at B=8), 896 (intra at B=8), 3072 (inter at B=64) and 7168 (intra
at B=64 x 112), Fq 40 and 48.  gru_bidir at N = 1 ... 7168 rows and L in
{1, 8, 13, 40, 48}; the stack at B = 1 ... 256 streams and the same Fq.
The weight layout the intra v2 wrapper hands the intra kernel
(``intra_v2_layout``) reads, from ``pack_intra_v2``'s tensors, exactly
the v1 packs' row blocks of each direction.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from dpdfnet_tpu_torch.ops import gru_kernels as gk

SMS = (132, 8)
INTER_N = (1, 2, 7, 8, 9, 63, 64, 65, 263, 264, 265, 320, 384, 527, 528, 529, 600, 1056,
           1057, 2560, 3072)
SCAN_N = (1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 384, 600, 3072)
SCAN_H = (32, 64, 96, 256)


def _covered_once(ranges, N):
    seen = [0] * N
    for r in ranges:
        for n in r:
            if n < N:
                seen[n] += 1
    assert seen == [1] * N


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N", INTER_N)
def test_inter_v2_plan_covers_every_row_once(N, sms):
    p = gk.inter_v2_plan(N, sms)
    _covered_once((p.rows(b, w) for b in range(p.blocks) for w in range(p.warps)), N)
    # no block without a real row: the grid is no larger than it must be
    assert p.rows(p.blocks - 1, 0).start < N
    assert p.rows_per_warp in (1, 2) and 1 <= p.warps <= 8
    assert p.smem_bytes == 4 * (64 * 256 + p.warps * 2 * p.rows_per_warp * 64)
    assert 3 * p.smem_bytes <= gk.SMEM_PER_BLOCK     # 3 blocks fit an SM
    warps_total = -(-N // p.rows_per_warp)
    # 2 rows per warp exactly while every SM keeps 2 warps
    assert (p.rows_per_warp == 2) == (-(-N // 2) >= 2 * sms)
    if p.warps < 8:                  # below 8 warps: one block per SM, or two on a full grid
        assert p.blocks <= (sms if warps_total <= 4 * sms else 2 * sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N", SCAN_N)
def test_gru_scan_plan_covers_every_row_and_unit_once(N, sms):
    for H in SCAN_H:
        p = gk.gru_scan_plan(N, H, sms)
        _covered_once((p.rows(q) for q in range(p.clusters)), N)
        _covered_once((p.units(c) for c in range(p.cluster)), H)
        assert p.rows(p.clusters - 1).start < N
        assert p.cluster == H // 32 <= gk.CLUSTER_MAX
        assert p.threads == H <= 1024
        assert p.rows_per_cluster in (1, 2, 4, 8)
        assert p.smem_bytes == 4 * (2 * p.rows_per_cluster * H + p.cluster * p.rows_per_cluster * 96)
        assert p.smem_bytes <= 48 * 1024 <= gk.SMEM_PER_BLOCK
        cap = max(1, sms // p.cluster)
        # the fewest rows per cluster that keep every cluster resident, else 8
        assert p.clusters <= cap or p.rows_per_cluster == 8
        if p.rows_per_cluster > 1:
            assert -(-N // (p.rows_per_cluster // 2)) > cap


def test_gru_scan_plan_takes_the_device_cluster_count():
    assert gk.gru_scan_plan(64, 256, 132, max_clusters=16).rows_per_cluster == 4
    assert gk.gru_scan_plan(64, 256, 132, max_clusters=8).rows_per_cluster == 8
    assert gk.gru_scan_plan(8, 256, 132, max_clusters=16).clusters == 8


@pytest.mark.parametrize("H", [16, 48, 288, 1024])
def test_gru_scan_plan_raises_outside_its_h_range(H):
    with pytest.raises(ValueError, match="from 32 to 256"):
        gk.gru_scan_plan(8, H, 132)


# ---- the v1 DPRNN walks (csrc/gru64_warp.cuh): inter_v1_plan, intra_plan ----

V1_N = (1, 64, 96, 384, 896, 3072, 7168)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N", V1_N)
def test_inter_v1_plan_covers_every_row_once(N, sms):
    for T in (1, 2, 112):
        p = gk.inter_v1_plan(N, T, sms)
        _covered_once((p.rows(b, w) for b in range(p.blocks) for w in range(p.warps)), N)
        assert p.rows(p.blocks - 1, 0).start < N
        assert p.rows_per_warp in (1, 2) and 1 <= p.warps <= gk.INTER_V1_MAX_WARPS
        assert p.smem_bytes <= gk.SMEM_PER_BLOCK
        # T == 1 hoists a one-step chunk; else 8 row-steps per pass over Wi
        assert p.ts == (1 if T == 1 else 8 // p.rows_per_warp)
        # one block per SM while 24 rows per SM hold every row
        if N <= 24 * sms:
            assert p.blocks <= sms
        # two rows per warp only where one per warp would need more than 8 warps
        assert (p.rows_per_warp == 2) == (-(-N // sms) > 8)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("Fq", (40, 48))
@pytest.mark.parametrize("N", V1_N)
def test_intra_plan_covers_every_row_and_direction_once(N, Fq, sms):
    p = gk.intra_plan(N, Fq, sms)
    assert p.cluster == 2 and p.ts == gk.INTRA_TS
    seen = {}
    for q in range(p.clusters):
        for d in range(p.cluster):              # CTA rank d walks direction d
            for tile in p.tiles_of(q):
                for w in range(p.walk_warps):
                    for n in p.rows(tile, w):
                        if n < N:
                            seen[(n, d)] = seen.get((n, d), 0) + 1
    assert seen == {(n, d): 1 for n in range(N) for d in range(2)}
    assert p.rows(p.tiles - 1, 0).start < N
    assert p.rows_per_warp in (1, 2)
    assert 1 <= p.walk_warps <= p.warps <= gk.INTRA_MAX_WARPS
    assert p.warps == max(p.walk_warps, gk.INTRA_MIN_WARPS)
    assert p.smem_bytes <= gk.SMEM_PER_BLOCK
    assert p.clusters == min(p.tiles, sms // 2)
    # the fewest rounds of tiles the largest tile allows
    rounds = -(-p.tiles // p.clusters)
    assert rounds == -(-N // ((sms // 2) * 2 * gk.INTRA_MAX_WARPS))
    # two rows per warp only where one per warp would need more than 8 warps
    assert (p.rows_per_warp == 2) == (-(-N // ((sms // 2) * rounds)) > gk.INTRA_MAX_WARPS)
    if N <= sms // 2:
        assert p.rows_per_tile == 1 and p.tiles == N



# ---- gru_bidir (csrc/gru_bidir.cu on the warp walk) and the DPRNN stack ----

BIDIR_N = (1, 2, 7, 64, 65, 132, 133, 896, 1001, 2112, 7168)
WALK_L = (1, 8, 13, 40, 48)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("L", WALK_L)
@pytest.mark.parametrize("N", BIDIR_N)
def test_gru_bidir_plan_covers_every_row_and_direction_once(N, L, sms):
    p = gk.gru_bidir_plan(N, L, sms)
    assert p.cluster == 2
    seen = Counter()
    for q in range(p.clusters):
        for d in range(2):                      # CTA 2q + d walks direction d
            for tile in p.tiles_of(q):
                for w in range(p.walk_warps):
                    for n in p.rows(tile, w):
                        if n < N:
                            seen[(n, d)] += 1
    assert seen == {(n, d): 1 for n in range(N) for d in range(2)}
    assert p.rows(p.tiles - 1, 0).start < N
    assert p.rows_per_warp in (1, 2) and p.ts == gk.INTRA_TS
    assert 1 <= p.walk_warps <= p.warps <= gk.INTRA_MAX_WARPS
    assert p.warps == max(p.walk_warps, gk.INTRA_MIN_WARPS)
    # Wi and Wh of one direction (96 KB) and the walking warps' slices
    assert p.smem_bytes == 4 * (2 * 64 * 192 + p.walk_warps * (
        p.ts * p.rows_per_warp * 256 + 2 * p.rows_per_warp * 64))
    assert p.smem_bytes <= gk.SMEM_PER_BLOCK
    assert p.clusters == min(p.tiles, sms // 2)
    # the same row split as the intra walk: fewest rounds, then smallest tiles
    ip = gk.intra_plan(N, L, sms)
    assert (p.rows_per_warp, p.walk_warps, p.tiles) == (ip.rows_per_warp, ip.walk_warps,
                                                        ip.tiles)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("Fq", WALK_L)
@pytest.mark.parametrize("B", (1, 2, 4, 8, 64, 66, 67, 133, 256))
def test_stack_plan_covers_every_stream_position_and_column_once(B, Fq, sms):
    p = gk.stack_plan(B, Fq, 8, sms)
    # a cluster per stream exactly while every cluster is resident at once
    assert p.cluster == (2 if 2 * B <= sms else 1) and p.ctas == p.cluster * B
    assert p.threads == gk.STACK_THREADS
    ctas_of = Counter(p.stream(c) for c in range(p.ctas))
    assert ctas_of == Counter({b: p.cluster for b in range(B)})
    # the inter gates and the store: each (stream, position) by one CTA
    own = Counter((p.stream(c), f) for c in range(p.ctas) for f in p.own_positions(c, Fq))
    assert own == Counter({(b, f): 1 for b in range(B) for f in range(Fq)})
    # the LayerNorms: every CTA holds the whole row, one warp per position
    for c in (0, p.ctas - 1):
        ln = Counter(f for w in range(p.warps) for f in p.ln_positions(w, Fq))
        assert ln == Counter({f: 1 for f in range(Fq)})
    # the walk: each (stream, direction, unit, column) on one thread, a lane
    # pair (2i, 2i + 1) of one warp holding one unit's four columns
    cols = Counter()
    for c in range(p.ctas):
        for t in range(p.threads):
            wc = p.walk_columns(c, t)
            if wc is None:
                assert p.cluster == 2 and t >= p.threads // 2
                continue
            d, u, pair = wc
            assert p.walk_columns(c, t ^ 1)[:2] == (d, u) and (t ^ 1) // 32 == t // 32
            cols.update((p.stream(c), d, u, col) for col in pair)
    assert cols == Counter({(b, d, u, col): 1 for b in range(B) for d in range(2)
                            for u in range(64) for col in ("r", "z", "n", "fc")})
    assert p.smem_bytes == 4 * (640 * Fq + 256) <= gk.SMEM_PER_BLOCK
    # the walk's 128 column weights per thread within the register budget of
    # one 256-thread CTA per SM
    assert p.weight_regs == 128 < p.reg_budget <= 255
    assert p.threads * p.reg_budget <= gk.REGS_PER_SM


@pytest.mark.parametrize("B,Fq,K", [(0, 48, 8), (4, 0, 8), (4, 51, 8), (4, 48, 0)])
def test_stack_plan_raises_outside_its_shapes(B, Fq, K):
    with pytest.raises(ValueError, match="stack_plan"):
        gk.stack_plan(B, Fq, K, 132)


# ---- the step-ablation kernels (csrc/*_step_ablation.cu): the production plans ----

@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("tool,N,T", [
    # the tools' default shapes, and the shapes of their --check on the card
    ("intra", 4096, 48), ("intra", 40, 16), ("inter", 6144, 56), ("inter", 40, 9)])
def test_ablation_specializations_launch_with_the_production_plan(tool, N, T, sms):
    """Every specialization of a step-ablation kernel hands its kernel the
    plan of the production kernel it is an instance of (intra_plan /
    inter_v1_plan), so `full` runs the production kernel as it ships."""
    from dpdfnet_tpu_torch.tools import inter_step_ablation, intra_step_ablation

    for i, spec in enumerate(intra_step_ablation.SPECS if tool == "intra"
                             else inter_step_ablation.SPECS):
        if tool == "intra":
            p = gk.intra_plan(N, T, sms)
            for tm in (False, True):
                assert intra_step_ablation.launch_args(spec, N, T, tm, sms) == (
                    i, N, T, int(tm), p.rows_per_warp, p.walk_warps, p.warps, p.clusters)
        else:
            p = gk.inter_v1_plan(N, T, sms)
            assert inter_step_ablation.launch_args(spec, N, T, sms) == (
                i, N, T, p.rows_per_warp, p.ts, p.warps, p.blocks)


# ---- intra v2 (csrc/dprnn_intra_v2.cu): the v2 packs read through the layout ----

@pytest.mark.parametrize("C", [8, 64])
def test_intra_v2_layout_reads_the_v1_blocks_of_each_direction(C):
    """Gathering through ``intra_v2_layout``'s offsets and leading
    dimensions, as ``csrc/dprnn_intra.cuh`` reads them (``PackLayout``),
    from ``wi_cat`` / ``wh_big`` gives each direction's row block of the v1
    ``wi2`` / ``wh2`` (its own gate-major columns) and of ``wfc``, exactly;
    every offset is a multiple of 4 floats (16-byte loads)."""
    rng = np.random.default_rng(17)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def gru():
        return {"wi": t(C, 3 * C), "bi": t(3 * C), "wh": t(C, 3 * C), "bh": t(3 * C)}

    wi2, wh2, _ = gk._pack_bidir(gru(), gru())
    wfc = t(2 * C, C)
    wi_cat, wh_big = gk.pack_intra_v2(wi2, wh2, wfc)
    lay = gk.intra_v2_layout(C)
    assert all(v % 4 == 0 for v in (lay.wi_drow, lay.wi_ld, lay.wh_ld, lay.fc_off,
                                     lay.fc_doff, lay.fc_ld))
    k = torch.arange(C)[:, None, None]
    gate = torch.arange(3)[None, :, None]
    u = torch.arange(C)[None, None, :]
    j = torch.arange(C)[None, :]
    for d in (0, 1):
        cols = gate * 2 * C + d * C + u
        wi = wi_cat.reshape(-1)[(d * lay.wi_drow + k) * lay.wi_ld + cols]
        wh = wh_big.reshape(-1)[(d * C + k) * lay.wh_ld + cols]
        fc = wh_big.reshape(-1)[lay.fc_off + d * lay.fc_doff + k[:, 0] * lay.fc_ld + j]
        rows = slice(d * C, (d + 1) * C)
        assert torch.equal(wi, wi2[rows].reshape(C, 3, 2, C)[:, :, d])
        assert torch.equal(wh, wh2[rows].reshape(C, 3, 2, C)[:, :, d])
        assert torch.equal(fc, wfc[rows])
