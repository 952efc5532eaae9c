"""The port's sequential kernels: DPRNN intra, DPRNN inter, GRU scan,
bidirectional GRU, the whole DPRNN stack, the v2 DPRNN intra / inter
stages with hoisted input projections, and the freq-major relayout.

Counterpart of ``dpdfnet_tpu.ops.pallas_gru``.  Each wrapper sits beside
its plain PyTorch version:

- for a tensor on the CPU the wrapper runs the plain version (that is what
  the CPU tests exercise);
- for a CUDA tensor it launches the hand-written CUDA kernel
  (``csrc/*.cu``, built for ``sm_90a`` by ``_build``) or raises.  There is
  no fallback;
- inside a ``force_disabled()`` block every wrapper runs its plain version
  for CUDA tensors too.  The kernels have no backward, so the train step
  (``train.make_train_step``) opens one around its forward and backward,
  as the JAX package's does (``pallas_gru.force_disabled``).  Nothing else
  opens one.

Each kernel is also the ``torch.library`` op ``torch.ops.dpdfnet.<wrapper
name>`` (CPU implementation: the plain version; CUDA: the launch; fake:
the output shapes), and the wrapper reaches it through that op, so eager
calls, CUDA graph capture and ``torch.export`` share one dispatch (see
"The kernels as torch.library ops" below).

Every wrapper carries a launch counter, ``<wrapper>.launches``, raised by
one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels (``launch_counts`` /
``reset_launch_counts``).  A launch recorded into a CUDA graph under
capture runs nothing and is not counted; the engine counts its graph
replays apart (``Engine.graph_replays``), and what a replay launches is
read from a device trace (``runtime/profile.py``).

Layouts follow the port's planes, not the TPU's time-major ones: the
kernels read ``[B, T, Fq, C]`` through strides.  Weight argument lists are
the JAX wrappers': packed ``wi2, wh2, b2`` for intra and the bidirectional
GRU, ``wi, bi, wh, bh, wfc, bfc, g, bln`` for inter, the ``pack_stack``
dict for the stack, ``pack_intra_v2``'s ``wi_cat, wh_big`` (+ ``b2``) for
intra v2 and ``whfc = [Wh | Wfc]`` for inter v2.  The CUDA kernels take
DPRNN planes with ``C == 64`` (every shipped configuration).

Planes (``x``, ``out``, ``ys``, and the v2 ``xp``) are float32 or
bfloat16; weights, biases and the carried ``h0`` / ``h_last`` are float32.
The math is float32 in every case: the kernels upcast plane loads and
round each plane store once, and the plain versions compute on the
upcast plane and round their result once, to the plane's dtype.  A
wrapper casts nothing around its kernel: other dtypes raise.

The JAX package's freq-major ("fm") DPRNN chain (its ``_dprnn_fused``
tm branch) is kept as layout modes of the intra and
inter kernels, each an op with its plain version:
``dprnn_intra_block(..., fm_batch=B)`` reads the freq-leading
``[Fq, T*B, C]`` plane and writes ``[T, Fq, B, C]``;
``dprnn_inter_block(..., fm_batch=B)`` reads that as ``[T, Fq*B, C]`` and
writes ``[Fq, T, B, C]``, with ``h_bm`` (hidden in the state's
``[B, Fq, C]``) and ``defer`` (the raw hidden out of the kernel, the fc +
LayerNorm + residual tail in PyTorch); ``relayout_fm`` is the chain's
entry permute.  The modes are stride sets and a template flag of the same
CUDA kernels.  No route of the model takes them: on one NVIDIA H100 80GB
HBM3 the fm chain ran bit-identical work 13-18% slower per exact hop at
64 streams and within 1.5% offline, and the deferred tail took 1.5536
against 0.7828 ms at B=64, so the model's DPRNN planes always travel
``[B, T, Fq, C]`` at the compute dtype (:func:`route_key` lists the
switches the model and the wrappers still read).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import _build
from .nn import gru_cell

Tensor = torch.Tensor

_LN_EPS = 1e-5

_FORCE_DISABLED = contextvars.ContextVar("dpdfnet_torch_force_disabled", default=0)


@contextlib.contextmanager
def force_disabled():
    """Run every wrapper's plain version, for CUDA tensors too, inside the
    block: the kernels are inference-only (no backward), so differentiating
    code wraps its forward and backward in this.  Nests; a
    ``ContextVar``, so another thread keeps its kernels
    (``pallas_gru.force_disabled``)."""
    token = _FORCE_DISABLED.set(_FORCE_DISABLED.get() + 1)
    try:
        yield
    finally:
        _FORCE_DISABLED.reset(token)


def kernels_disabled() -> bool:
    """Is a :func:`force_disabled` block open in this thread?"""
    return _FORCE_DISABLED.get() > 0


def _plain(x: Tensor) -> bool:
    """Take the plain version: ``x`` lies on the CPU, or a
    :func:`force_disabled` block is open."""
    return x.device.type == "cpu" or kernels_disabled()


# --------------------------------------------------------------------------- #
# Plain versions (the CPU path and the oracles the kernels are held against)
# --------------------------------------------------------------------------- #

def _ln(y: Tensor, g: Tensor, b: Tensor) -> Tensor:
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + _LN_EPS) * g + b


def gru_scan_plain(x: Tensor, h0: Optional[Tensor], wi: Tensor, bi: Tensor,
                   wh: Tensor, bh: Tensor, reverse: bool = False
                   ) -> Tuple[Tensor, Tensor]:
    """GRU over ``x [N, T, I]`` from ``h0 [N, H]`` (zeros when None);
    returns ``(ys [N, T, H]`` at x's dtype, ``h_last [N, H]`` float32)."""
    N, T, _ = x.shape
    H = wh.shape[0]
    h = x.new_zeros((N, H), dtype=torch.float32) if h0 is None else h0.float()
    xp = x.float() @ wi + bi                                    # [N, T, 3H]
    ys = [None] * T
    for s in range(T):
        t = T - 1 - s if reverse else s
        h = gru_cell({"wh": wh, "bh": bh}, xp[:, t], h)
        ys[t] = h
    return torch.stack(ys, dim=1).to(x.dtype), h


def _pack_bidir(p_fw: dict, p_bw: dict):
    """Stack two GRU parameter sets direction-blockdiag, gate-major.

    Returns ``(wi2 [2I, 6H], wh2 [2H, 6H], b2 [2, 6H])``; the 6H column
    axis is ``[r_f r_b z_f z_b n_f n_b]``, the row axis ``[fw | bw]`` with
    zero cross-direction blocks (``pallas_gru._pack_bidir``).
    """
    H = p_fw["wh"].shape[0]

    def pack(wf, wb):
        rows = wf.shape[0]
        out = wf.new_zeros((2 * rows, 6 * H))
        for g in range(3):                       # r, z, n gate blocks
            out[:rows, (2 * g) * H:(2 * g + 1) * H] = wf[:, g * H:(g + 1) * H]
            out[rows:, (2 * g + 1) * H:(2 * g + 2) * H] = wb[:, g * H:(g + 1) * H]
        return out

    def packb(bf, bb):
        out = bf.new_zeros((6 * H,))
        for g in range(3):
            out[(2 * g) * H:(2 * g + 1) * H] = bf[g * H:(g + 1) * H]
            out[(2 * g + 1) * H:(2 * g + 2) * H] = bb[g * H:(g + 1) * H]
        return out

    wi2 = pack(p_fw["wi"], p_bw["wi"])
    wh2 = pack(p_fw["wh"], p_bw["wh"])
    b2 = torch.stack([packb(p_fw["bi"], p_bw["bi"]),
                      packb(p_fw["bh"], p_bw["bh"])])
    return wi2, wh2, b2


def gru_bidir_plain(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Bidirectional GRU along L of ``x [N, L, I]`` from zero state with the
    packed direction-blockdiag weights (``_pack_bidir``); both directions
    advance in one walk.  Returns ``(ys_fw, ys_bw)``, each ``[N, L, H]``
    at x's dtype."""
    dtype = x.dtype
    x = x.float()
    N, L, _ = x.shape
    H = wh2.shape[0] // 2
    H2 = 2 * H
    h = x.new_zeros((N, H2))
    ys_f, ys_b = [None] * L, [None] * L
    for s in range(L):
        x2 = torch.cat([x[:, s], x[:, L - 1 - s]], dim=-1)
        xp = x2 @ wi2 + b2[0]
        hh = h @ wh2 + b2[1]
        r = torch.sigmoid(xp[:, :H2] + hh[:, :H2])
        z = torch.sigmoid(xp[:, H2:2 * H2] + hh[:, H2:2 * H2])
        n = torch.tanh(xp[:, 2 * H2:] + r * hh[:, 2 * H2:])
        h = (1.0 - z) * n + z * h
        ys_f[s] = h[:, :H]
        ys_b[L - 1 - s] = h[:, H:]
    return torch.stack(ys_f, 1).to(dtype), torch.stack(ys_b, 1).to(dtype)


def dprnn_intra_block_plain(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor,
                            wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor, *,
                            fm_batch: Optional[int] = None) -> Tensor:
    """``x + LN(fc(bidirGRU_along_Fq(x)))`` over ``x [N, Fq, C]`` with the
    packed direction-blockdiag weights (``_pack_bidir``).  ``fm_batch=B``:
    ``x`` is the freq-leading ``[Fq, N, C]`` with ``N = T*B`` t-major rows,
    and the result the ``[T, Fq, B, C]`` plane."""
    if fm_batch:
        Fq, N, C = x.shape
        out = dprnn_intra_block_plain(x.transpose(0, 1), wi2, wh2, b2, wfc, bfc, g, bln)
        return out.reshape(N // fm_batch, fm_batch, Fq, C).transpose(1, 2).contiguous()
    xf = x.float()
    ys = torch.cat(gru_bidir_plain(xf, wi2, wh2, b2), dim=-1)
    return (xf + _ln(ys @ wfc + bfc, g, bln)).to(x.dtype)


def dprnn_inter_block_plain(x: Tensor, h0: Tensor, wi: Tensor, bi: Tensor,
                            wh: Tensor, bh: Tensor, wfc: Tensor, bfc: Tensor,
                            g: Tensor, bln: Tensor, *, fm_batch: Optional[int] = None,
                            h_bm: bool = False, defer: bool = False
                            ) -> Tuple[Tensor, Tensor]:
    """GRU along T for every (b, f) row of ``x [B, T, Fq, C]`` from
    ``h0 [B, Fq, C]``; ``out[t] = x[t] + LN(fc(h_t))``.  Returns
    ``(out [B, T, Fq, C]`` at x's dtype, ``h_last [B, Fq, C]`` float32).

    ``fm_batch=B``: ``x`` is ``[T, Fq*B, C]`` with f-major rows, ``out``
    ``[Fq, T, B, C]``, and ``h0`` / ``h_last`` ``[Fq*B, C]`` in the rows'
    order, or ``[B, Fq, C]`` with ``h_bm``.  ``defer``: ``out`` is the raw
    hidden ``h_t`` at x's dtype (the kernel's defer mode, whose tail
    :func:`inter_tail` applies)."""
    if fm_batch:
        T, N, C = x.shape
        B, Fq = fm_batch, N // fm_batch
        h0b = h0 if h_bm else h0.reshape(Fq, B, C).transpose(0, 1)
        out, hl = dprnn_inter_block_plain(x.reshape(T, Fq, B, C).permute(2, 0, 1, 3), h0b,
                                          wi, bi, wh, bh, wfc, bfc, g, bln, defer=defer)
        hl = hl if h_bm else hl.transpose(0, 1).reshape(N, C)
        return out.permute(2, 1, 0, 3).contiguous(), hl.contiguous()
    B, T, Fq, C = x.shape
    xf = x.float()
    xt = xf.transpose(1, 2).reshape(B * Fq, T, C)
    ys, hl = gru_scan_plain(xt, h0.reshape(B * Fq, C), wi, bi, wh, bh)
    if defer:
        return ys.reshape(B, Fq, T, C).transpose(1, 2).to(x.dtype), hl.reshape(B, Fq, C)
    y = _ln(ys @ wfc + bfc, g, bln)
    out = xf + y.reshape(B, Fq, T, C).transpose(1, 2)
    return out.to(x.dtype), hl.reshape(B, Fq, C)


def inter_tail(h: Tensor, x: Tensor, wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor
               ) -> Tensor:
    """The deferred inter tail: ``x + LN(h . Wfc + bfc)`` over the raw
    hidden plane ``h`` and the plane ``x`` in the same layout, in float32
    (``h`` keeps its plane rounding, as in the JAX package), rounded to x's
    dtype."""
    return (x.float() + _ln(h.float() @ wfc + bfc, g, bln)).to(x.dtype)


def relayout_fm_plain(x: Tensor, out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """``[B, T, F, C] -> [F, T, B, C]``, cast to ``out_dtype`` (default x's)."""
    return x.permute(2, 1, 0, 3).to(out_dtype or x.dtype).contiguous()


def pack_intra_v2(wi2: Tensor, wh2: Tensor, wfc: Tensor) -> Tuple[Tensor, Tensor]:
    """The v2 intra weights from the v1 packed set and the fc weight
    (``pallas_gru.pack_intra_v2``): ``wi_cat [C, 6C]`` collapses wi2's two
    row blocks (their nonzero columns are disjoint); ``wh_big [2C, 8C]``
    appends ``blockdiag(wfc[:C], wfc[C:])`` columns to wh2."""
    I = wi2.shape[0] // 2
    C = wh2.shape[0] // 2
    wi_cat = wi2[:I] + wi2[I:]
    fc_blk = wfc.new_zeros((2 * C, 2 * C))
    fc_blk[:C, :C] = wfc[:C]
    fc_blk[C:, C:] = wfc[C:]
    return wi_cat, torch.cat([wh2, fc_blk], dim=1)


def dprnn_intra_block_v2_plain(x: Tensor, wi_cat: Tensor, wh_big: Tensor, b2: Tensor,
                               bfc: Tensor, g: Tensor, bln: Tensor, *,
                               xp_bf16: bool = True) -> Tensor:
    """The v2 intra stage on ``x [N, L, C]``: ``xp = x . wi_cat + b2[0]``
    for every position at once (rounded to bfloat16 when ``xp_bf16``), then
    the bidirectional walk (forward-direction gate columns of xp from
    position s, backward ones from L-1-s) and ``x + LN(fc([ys_fw, ys_bw]))``
    with the fc read from wh_big's blockdiag columns.  The same function as
    :func:`dprnn_intra_block_plain` up to the xp rounding."""
    N, L, C = x.shape
    C2, H6 = 2 * C, 6 * C
    xf = x.float()
    xp = xf @ wi_cat + b2[0]                                     # [N, L, 6C]
    if xp_bf16:
        xp = xp.to(torch.bfloat16).float()
    is_f = (torch.arange(H6, device=x.device) // C) % 2 == 0     # [r_f r_b z_f z_b n_f n_b]
    wh2 = wh_big[:, :H6]
    h = xf.new_zeros((N, C2))
    ys_f, ys_b = [None] * L, [None] * L
    for s in range(L):
        xp2 = torch.where(is_f, xp[:, s], xp[:, L - 1 - s])
        hh = h @ wh2 + b2[1]
        r = torch.sigmoid(xp2[:, :C2] + hh[:, :C2])
        z = torch.sigmoid(xp2[:, C2:2 * C2] + hh[:, C2:2 * C2])
        n = torch.tanh(xp2[:, 2 * C2:] + r * hh[:, 2 * C2:])
        h = (1.0 - z) * n + z * h
        ys_f[s] = h[:, :C]
        ys_b[L - 1 - s] = h[:, C:]
    wfc = torch.cat([wh_big[:C, H6:H6 + C], wh_big[C:, H6 + C:]], dim=0)
    ys = torch.cat([torch.stack(ys_f, 1), torch.stack(ys_b, 1)], dim=-1)
    return (xf + _ln(ys @ wfc + bfc, g, bln)).to(x.dtype)


def dprnn_inter_block_v2_plain(xp: Tensor, x: Tensor, h0: Tensor, whfc: Tensor, bh: Tensor,
                               bfc: Tensor, g: Tensor, bln: Tensor) -> Tuple[Tensor, Tensor]:
    """The v2 inter stage: the GRU along T of every (b, f) row of the plane
    ``x [B, T, Fq, C]`` from ``h0 [B, Fq, C]``, with the input projections
    ``xp [B, T, Fq, 3C] = x . Wi + bi`` given, and ``whfc = [Wh | Wfc]``;
    ``out[t] = x[t] + LN(h_t . Wfc + bfc)``.  Returns ``(out`` at x's
    dtype, ``h_last [B, Fq, C]`` float32)."""
    B, T, Fq, C = x.shape
    xpt = xp.float().transpose(1, 2).reshape(B * Fq, T, 3 * C)
    wh, wfc = whfc[:, :3 * C], whfc[:, 3 * C:]
    h = h0.float().reshape(B * Fq, C)
    hs = []
    for t in range(T):
        h = gru_cell({"wh": wh, "bh": bh}, xpt[:, t], h)
        hs.append(h)
    y = _ln(torch.stack(hs, dim=1) @ wfc + bfc, g, bln)
    out = x.float() + y.reshape(B, Fq, T, C).transpose(1, 2)
    return out.to(x.dtype), h.reshape(B, Fq, C)


def dprnn_stack_plain(x: Tensor, h0: Tensor, stacked: Dict[str, Tensor]
                      ) -> Tuple[Tensor, Tensor]:
    """K DPRNN blocks over ``x [B, T, Fq, C]`` one frame at a time
    (``_stack_kernel``'s order): per t, for each block k, the intra stage
    (bidirectional GRU along Fq from zero + fc + LN + residual), then one
    inter GRU step on ``h[k]`` + fc + LN + residual.  ``h0 [K, B, Fq, C]``;
    returns ``(out [B, T, Fq, C], h_last [K, B, Fq, C])``."""
    B, T, Fq, C = x.shape
    K = h0.shape[0]
    w = stacked
    hs = [h0[k].float() for k in range(K)]
    outs = []
    for t in range(T):
        cur = x[:, t].float()                                   # [B, Fq, C]
        for k in range(K):
            cur = dprnn_intra_block_plain(
                cur, w["wi2"][k], w["wh2"][k], w["b2"][k], w["wfc_i"][k],
                w["bfc_i"][k, 0], w["g_i"][k, 0], w["bln_i"][k, 0])
            xp = cur @ w["wi_t"][k] + w["b2_t"][k, 0]
            hs[k] = gru_cell({"wh": w["wh_t"][k], "bh": w["b2_t"][k, 1]}, xp, hs[k])
            cur = cur + _ln(hs[k] @ w["wfc_t"][k] + w["bfc_t"][k, 0],
                            w["g_t"][k, 0], w["bln_t"][k, 0])
        outs.append(cur)
    return torch.stack(outs, dim=1).to(x.dtype), torch.stack(hs)


BF16_ULP = 2.0 ** -7


def err_beyond_bf16_ulp(got: Tensor, ref: Tensor, slack: Optional[Tensor] = None) -> float:
    """Max-abs of ``got - ref`` beyond one bfloat16 ulp of ``ref``
    (``BF16_ULP`` of its magnitude) where ``ref`` is bfloat16; the plain
    max-abs where it is float32.  A bf16-plane kernel and its plain version
    each compute in float32 and round the plane once, so a float32
    difference next to a rounding midpoint can land one ulp apart.
    ``slack`` (broadcast against ``ref``): a further per-element allowance,
    for a function that rounds intermediate values to bfloat16 itself."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise ValueError(f"got {got.dtype} {tuple(got.shape)}, "
                         f"ref {ref.dtype} {tuple(ref.shape)}")
    d = (got.float() - ref.float()).abs()
    if ref.dtype == torch.bfloat16:
        d = d - ref.float().abs() * BF16_ULP
    if slack is not None:
        d = d - slack
    return d.max().item()


def stack_enabled() -> bool:
    """Run each DPRNN stack as one ``dprnn_stack`` launch?
    (``DPDFNET_TPU_STACK=0/1``, default off: the same variable and default
    as ``pallas_gru.stack_enabled``.)  Read where the weights are packed
    (``models.fuse.pack_dprnn_bidir``) and where the stack is dispatched
    (``models.dpdfnet._dprnn``): set it before building the engine."""
    return os.environ.get("DPDFNET_TPU_STACK", "0") not in ("0", "false", "False")


def v2_requested() -> bool:
    """``DPDFNET_TPU_PALLAS_V2`` set (no precision gate): read where the
    weights are packed (``models.fuse.pack_dprnn_bidir``), where the run's
    precision is not known yet (``pallas_gru.v2_requested``)."""
    env = os.environ.get("DPDFNET_TPU_PALLAS_V2")
    return env is not None and env not in ("0", "false", "False")


def v2_enabled(precision: str) -> bool:
    """Take the inter v2 kernel in the DPRNN stack?  Only under the
    ``"default"`` precision of the ``fast`` / ``turbo`` tiers, whose
    accuracy contract covers the bf16 storage of the hoisted projections
    (``pallas_gru.v2_enabled``); read at each call."""
    return precision == "default" and v2_requested()


def route_key(precision: str) -> tuple:
    """The switches the model (``models.dpdfnet``) and these wrappers read
    per call at ``precision``: the stack kernel, the inter v2 kernel and an
    open :func:`force_disabled` block.  A program captured under one key
    must not replay under another (``runtime.engine.stream_graph_key``)."""
    return stack_enabled(), v2_enabled(precision), kernels_disabled()


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "dprnn_inter_launch": [_P] * 12 + [_I] * 11 + [_P],
    "dprnn_inter_v2_launch": [_P] * 10 + [_I] * 8 + [_P],
    "dprnn_intra_launch": [_P] * 10 + [_L, _I, _L] + [_I] * 5 + [_P],
    "dprnn_intra_v2_launch": [_P] * 9 + [_L] + [_I] * 13 + [_P],
    "dprnn_stack_launch": [_P] * 18 + [_I] * 7 + [_P],
    "gru_bidir_launch": [_P] * 6 + [_L] + [_I] * 6 + [_P],
    "gru_scan_launch": [_P] * 9 + [_I] * 8 + [_P],
    "gru_scan_max_clusters": [_I, ctypes.POINTER(ctypes.c_int)],
    "relayout_fm_launch": [_P, _P] + [_L] * 4 + [_I] * 3 + [_P],
}
_PLANE_DTYPES = (torch.float32, torch.bfloat16)
_STACK_FQ_MAX = 50          # csrc/dprnn_stack.cu (129 KB of shared memory at Fq = 50)


def _stack_shapes(K: int, C: int) -> Dict[str, tuple]:
    """``pack_stack``'s keys, in the order the stack kernel takes them, with
    their shapes for K blocks of width C."""
    row = (K, 1, C)
    return {"wi2": (K, 2 * C, 6 * C), "wh2": (K, 2 * C, 6 * C), "b2": (K, 2, 6 * C),
            "wfc_i": (K, 2 * C, C), "bfc_i": row, "g_i": row, "bln_i": row,
            "wi_t": (K, C, 3 * C), "wh_t": (K, C, 3 * C), "b2_t": (K, 2, 3 * C),
            "wfc_t": (K, C, C), "bfc_t": row, "g_t": row, "bln_t": row}


def _fn(lib_name: str, fn_name: str):
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def _count_launch(wrapper) -> None:
    """Count a launch of ``wrapper``'s kernel, unless it was recorded into
    a CUDA graph under capture: a capture runs nothing."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def _launch(what: str, wrapper, dev: torch.device, fn, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` with ``dev``, the device of
    the tensors that :func:`_require_cuda` checked, as the current device
    and ``stream`` its current stream: the entry sets per-device kernel
    attributes and launches on the current device, so a tensor on another
    card than the current one still runs where it lies.  Then check the
    entry's return code and count the launch on ``wrapper``."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        _check_rc(rc, what)
        _count_launch(wrapper)


def _require_cuda(what: str, planes: Dict[str, Tensor], weights: Dict[str, Tensor]
                  ) -> torch.device:
    """Every tensor contiguous on one CUDA device; planes float32 or
    bfloat16, weights (biases and carried hiddens included) float32.
    Raises otherwise: nothing is cast around a kernel."""
    dev = None
    for group, allowed, kind in ((planes, _PLANE_DTYPES, "float32 or bfloat16"),
                                 (weights, (torch.float32,), "float32")):
        for name, t in group.items():
            if not t.is_cuda:
                raise ValueError(f"{what}: {name} is on {t.device}, expected a CUDA tensor")
            if t.dtype not in allowed:
                raise ValueError(f"{what}: {name} is {t.dtype}; the kernel takes {kind}")
            if not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous")
            if dev is None:
                dev = t.device
            elif t.device != dev:
                raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    return dev


def _is_bf16(t: Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _require_aligned(what: str, **tensors: Tensor) -> None:
    """The warp walk stages these weights with 16-byte loads."""
    bad = [k for k, t in tensors.items() if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{what}: the kernel reads {', '.join(bad)} 16-byte aligned")


# --------------------------------------------------------------------------- #
# Launch plans of the inter v2 walk and the cluster GRU scan (pure Python, so
# the CPU tests check them; the kernels index rows exactly as ``rows`` says)
# --------------------------------------------------------------------------- #

SMEM_PER_BLOCK = 232448     # bytes of shared memory one H100 block may use (227 KB)
CLUSTER_MAX = 8             # the portable thread-block cluster size
GRU_SCAN_H_MAX = 32 * CLUSTER_MAX   # csrc/gru_scan.cu: one CTA per 32 hidden units


@dataclass(frozen=True)
class InterV2Plan:
    """``csrc/dprnn_inter_v2.cu``: ``blocks`` blocks of ``warps`` warps,
    each warp owning ``rows_per_warp`` consecutive rows of the plane."""
    rows_per_warp: int
    warps: int
    blocks: int
    smem_bytes: int

    def rows(self, block: int, warp: int) -> range:
        start = (block * self.warps + warp) * self.rows_per_warp
        return range(start, start + self.rows_per_warp)


def inter_v2_plan(N: int, sms: int) -> InterV2Plan:
    """The launch plan of the inter v2 walk for ``N = B * Fq`` rows on a
    card with ``sms`` SMs.  Rows per warp: 2 while that still gives every
    SM two warps (each weight load then feeds two rows), else 1.  Warps per
    block (up to 8): one block per SM while the grid has at most 4 warps
    per SM, else two blocks per SM.  Each block stages the 64 KB of packed
    weights once; with at most 72 KB of shared memory per block, 3 blocks
    fit an SM.  On an H100 at 700 W this was the fastest plan of a sweep
    over rows per warp and warps per block at B=8 (384 rows: 1 row per
    warp, 3 warps per block) and B=64 (3072 rows: 2 rows per warp, 6
    warps per block)."""
    if N < 1 or sms < 1:
        raise ValueError(f"inter_v2_plan: N={N}, sms={sms}")
    R = 2 if -(-N // 2) >= 2 * sms else 1
    warps_total = -(-N // R)
    per_sm = 1 if warps_total <= 4 * sms else 2
    warps = min(8, -(-warps_total // (per_sm * sms)))
    smem = 4 * (64 * 256 + warps * 2 * R * 64)
    return InterV2Plan(R, warps, -(-warps_total // warps), smem)


# csrc/gru64_warp.cuh: the staged Wi + [Wh | Wfc] of one direction, and one
# warp's chunk slots [TS][R][8 * 32] and hidden [2][R][C] (floats, C = 64)
_WARP_WALK_W_FLOATS = 64 * 3 * 32 * 2 + 64 * 2 * 32 * 4


def _warp_walk_floats(R: int, ts: int) -> int:
    return ts * R * 8 * 32 + 2 * R * 64


@dataclass(frozen=True)
class InterV1Plan:
    """``csrc/dprnn_inter.cu``: ``blocks`` blocks (one per SM) of ``warps``
    warps, each warp owning ``rows_per_warp`` consecutive rows and
    hoisting the input projection ``ts`` steps at a time."""
    rows_per_warp: int
    warps: int
    blocks: int
    ts: int
    smem_bytes: int

    def rows(self, block: int, warp: int) -> range:
        start = (block * self.warps + warp) * self.rows_per_warp
        return range(start, start + self.rows_per_warp)


INTER_V1_MAX_WARPS = 12     # csrc/dprnn_inter.cu


def inter_v1_plan(N: int, T: int, sms: int) -> InterV1Plan:
    """The launch plan of the v1 inter walk for ``N = B * Fq`` rows over T
    steps on a card with ``sms`` SMs.  The 112 KB of staged weights allow
    one block per SM, so the rows are spread over every SM first: up to 8
    rows per SM one row per warp, above that two rows per warp (each
    weight load then feeds two rows) and up to 12 warps per block, then
    further blocks.  TS, the steps whose input projections one pass over
    Wi computes: 1 at T == 1, else 8 / rows per warp (48 accumulators per
    lane either way)."""
    if N < 1 or T < 1 or sms < 1:
        raise ValueError(f"inter_v1_plan: N={N}, T={T}, sms={sms}")
    per_sm = -(-N // sms)
    R = 1 if per_sm <= 8 else 2
    warps = max(1, min(8 if R == 1 else INTER_V1_MAX_WARPS, -(-per_sm // R)))
    ts = 1 if T == 1 else 8 // R
    smem = 4 * (_WARP_WALK_W_FLOATS + warps * _warp_walk_floats(R, ts))
    return InterV1Plan(R, warps, -(-N // (warps * R)), ts, smem)


@dataclass(frozen=True)
class IntraPlan:
    """``csrc/dprnn_intra.cu``: ``clusters`` clusters of ``cluster`` CTAs
    (CTA rank d walks direction d) of ``warps`` warps, persistent over the
    ``tiles`` row tiles: cluster q walks tiles q, q + clusters, ...; warp
    w < ``walk_warps`` of a tile owns ``rows_per_warp`` consecutive rows
    (every warp stages weights and runs the epilogue); ``ts`` steps of
    input projection per pass over Wi."""
    cluster: int
    rows_per_warp: int
    walk_warps: int
    warps: int
    ts: int
    tiles: int
    clusters: int
    smem_bytes: int

    @property
    def rows_per_tile(self) -> int:
        return self.walk_warps * self.rows_per_warp

    def rows(self, tile: int, warp: int) -> range:
        start = tile * self.rows_per_tile + warp * self.rows_per_warp
        return range(start, start + self.rows_per_warp)

    def tiles_of(self, q: int) -> range:
        return range(q, self.tiles, self.clusters)


INTRA_MAX_WARPS = 8         # csrc/dprnn_intra.cu
INTRA_MIN_WARPS = 4         # warps per CTA that stage the weights and share the epilogue
INTRA_TS = 4


def _tiles(N: int, ctas: int, max_warps: int) -> Tuple[int, int, int]:
    """(rows per warp, walking warps, tiles) of a persistent warp walk of N
    rows on ``ctas`` CTAs of up to ``max_warps`` walking warps: the fewest
    rounds of tiles that the largest tile (two rows per warp) allows, then
    the smallest tile that keeps to that many rounds; one row per warp up
    to ``max_warps`` rows per tile, else two (each weight load then feeds
    two rows)."""
    rounds = -(-N // (ctas * 2 * max_warps))
    want = -(-N // (ctas * rounds))                     # rows per tile
    R = 1 if want <= max_warps else 2
    walk = -(-want // R)
    return R, walk, -(-N // (walk * R))


def intra_plan(N: int, Fq: int, sms: int) -> IntraPlan:
    """The launch plan of the intra walk for ``N = B * T`` rows of ``Fq``
    positions on a card with ``sms`` SMs.  Each CTA stages 112 KB of one
    direction's weights, so one CTA fits an SM and a tile holds up to 8
    walking warps.  The tiles are balanced over the ``sms // 2`` clusters
    the card runs at once (:func:`_tiles`).  A CTA has at least
    ``INTRA_MIN_WARPS`` warps, so small tiles still stage their weights and
    run their epilogue with four warps.  The fc partials go to a
    device-memory scratch."""
    if N < 1 or Fq < 1 or sms < 2:
        raise ValueError(f"intra_plan: N={N}, Fq={Fq}, sms={sms}")
    pairs = sms // 2
    R, walk, tiles = _tiles(N, pairs, INTRA_MAX_WARPS)
    smem = 4 * (_WARP_WALK_W_FLOATS + walk * _warp_walk_floats(R, INTRA_TS))
    return IntraPlan(2, R, walk, max(walk, INTRA_MIN_WARPS), INTRA_TS, tiles,
                     min(tiles, pairs), smem)


@dataclass(frozen=True)
class IntraLayout:
    """Where direction d of the intra kernel reads its weights
    (``csrc/dprnn_intra.cuh``, ``intra::PackLayout``; element offsets into
    each tensor, gate-major columns ``[r_f r_b z_f z_b n_f n_b]``):

    - Wi element (k, gate, u) at ``wi[(d * wi_drow + k) * wi_ld + gate * 2C + d * C + u]``;
    - Wh element (k, gate, u) at ``wh[(d * C + k) * wh_ld + gate * 2C + d * C + u]``;
    - fc element (k, j) at ``fc[fc_off + d * fc_doff + k * fc_ld + j]``.

    The kernel stages them with 16-byte loads, so every offset is a
    multiple of 4 floats."""
    wi_drow: int
    wi_ld: int
    wh_ld: int
    fc_off: int
    fc_doff: int
    fc_ld: int


def intra_v2_layout(C: int = 64) -> IntraLayout:
    """:func:`pack_intra_v2`'s tensors as the intra kernel reads them:
    both directions' Wi in ``wi_cat [C, 6C]``'s rows, Wh in ``wh_big
    [2C, 8C]``'s first 6C columns, and the fc in its blockdiag columns, so
    direction d's fc block starts at row d * C, column 6C + d * C of
    ``wh_big``.  The zero cross-direction blocks are never read."""
    return IntraLayout(wi_drow=0, wi_ld=6 * C, wh_ld=8 * C, fc_off=6 * C,
                       fc_doff=C * 8 * C + C, fc_ld=8 * C)


# csrc/gru_bidir.cu: the staged Wi and Wh of one direction (floats)
_BIDIR_W_FLOATS = 2 * 64 * 3 * 32 * 2


def gru_bidir_plan(N: int, L: int, sms: int) -> IntraPlan:
    """The launch plan of the bidirectional GRU walk (``csrc/gru_bidir.cu``)
    for N rows of L steps on a card with ``sms`` SMs: intra's plan without
    the fc.  Each CTA stages 96 KB of one direction's Wi and Wh, so one CTA
    fits an SM; ``clusters`` pairs of CTAs (CTA 2q + d walks direction d of
    pair q's tiles; no hardware cluster: the directions share nothing)
    split the rows into tiles of up to 8 walking warps (:func:`_tiles`),
    with at least ``INTRA_MIN_WARPS`` warps per CTA to stage the weights."""
    if N < 1 or L < 1 or sms < 2:
        raise ValueError(f"gru_bidir_plan: N={N}, L={L}, sms={sms}")
    pairs = sms // 2
    R, walk, tiles = _tiles(N, pairs, INTRA_MAX_WARPS)
    smem = 4 * (_BIDIR_W_FLOATS + walk * _warp_walk_floats(R, INTRA_TS))
    return IntraPlan(2, R, walk, max(walk, INTRA_MIN_WARPS), INTRA_TS, tiles,
                     min(tiles, pairs), smem)


@dataclass(frozen=True)
class StackPlan:
    """``csrc/dprnn_stack.cu``: ``ctas`` CTAs of ``threads`` threads,
    ``cluster`` (1 or 2) per stream: CTA i runs stream ``i // cluster``
    through every frame and block.  One CTA per stream walks both
    directions (threads 0-127 forward, 128-255 backward); a two-CTA cluster
    walks direction r in CTA rank r (threads 0-127) while threads 128-255
    compute the inter h . Wh columns.  A walking lane pair owns one hidden
    unit, the even thread its r and z columns of [Wh_d | Wfc_d], the odd
    one its n and fc columns (``walk_columns``), ``weight_regs`` weights in
    registers; every CTA runs the LayerNorms of all positions, warp w taking
    w, w + warps, ... (``ln_positions``); the inter gates and the output
    store of a cluster are split between its CTAs (``own_positions``).
    Either way a row's arithmetic is the same, so both give the same bits
    (those of the per-stage kernels on float32 planes)."""
    cluster: int
    ctas: int
    threads: int
    smem_bytes: int
    weight_regs: int
    reg_budget: int

    @property
    def warps(self) -> int:
        return self.threads // 32

    def stream(self, cta: int) -> int:
        return cta // self.cluster

    def ln_positions(self, warp: int, Fq: int) -> range:
        return range(warp, Fq, self.warps)

    def own_positions(self, cta: int, Fq: int) -> range:
        if self.cluster == 1:
            return range(Fq)
        hf = (Fq + 1) // 2
        return range(0, hf) if cta % 2 == 0 else range(hf, Fq)

    def walk_columns(self, cta: int, thread: int) -> Optional[Tuple[int, int, Tuple[str, str]]]:
        """(direction, unit, the thread's two columns of [Wh_d | Wfc_d]), or
        None for a thread that does not walk."""
        half = self.threads // 2
        if self.cluster == 1:
            d, i = divmod(thread, half)
        elif thread < half:
            d, i = cta % 2, thread
        else:
            return None
        return d, i // 2, (("n", "fc") if i % 2 else ("r", "z"))


STACK_THREADS = 256         # csrc/dprnn_stack.cu
REGS_PER_SM = 65536


def _stack_smem_floats(Fq: int) -> int:
    # scur [Fq][C], sxp [2][Fq][3C], spart [2][Fq][C], sh [Fq][C], shb [2][2][C]
    C = 64
    return Fq * C + 2 * Fq * 3 * C + 2 * Fq * C + Fq * C + 4 * C


def stack_plan(B: int, Fq: int, K: int, sms: int) -> StackPlan:
    """The launch plan of the DPRNN stack for B streams of Fq positions and
    K blocks on a card with ``sms`` SMs: a two-CTA cluster per stream while
    every cluster is resident at once (2 B <= sms), which halves each
    stream's column work per SM and gives the inter h . Wh product to the
    CTA's non-walking warps during the walk; else one 256-thread CTA per
    stream (more streams per wave).  On an H100 at 700 W the cluster took
    0.38 against 0.48 ms for one exact hop of 64 streams (K = 8, Fq = 48)
    and 1.50 against 0.98 ms at 256 streams.  The walk's 128 column weights per thread sit in
    registers, so one CTA fits an SM (the register file gives each thread
    at most 255)."""
    if B < 1 or K < 1 or sms < 1 or not 1 <= Fq <= _STACK_FQ_MAX:
        raise ValueError(f"stack_plan: B={B}, Fq={Fq} (1 .. {_STACK_FQ_MAX}), K={K}, "
                         f"sms={sms}")
    cluster = 2 if 2 * B <= sms else 1
    return StackPlan(cluster, cluster * B, STACK_THREADS, 4 * _stack_smem_floats(Fq), 2 * 64,
                     min(255, REGS_PER_SM // STACK_THREADS))


@dataclass(frozen=True)
class GruScanPlan:
    """``csrc/gru_scan.cu``: ``clusters`` clusters of ``cluster`` CTAs (one
    per 32 hidden units, ``threads`` = H threads each), cluster q walking
    rows q * R .. q * R + R - 1 (``rows_per_cluster`` = R)."""
    cluster: int
    rows_per_cluster: int
    clusters: int
    threads: int
    smem_bytes: int

    def rows(self, q: int) -> range:
        return range(q * self.rows_per_cluster, (q + 1) * self.rows_per_cluster)

    def units(self, rank: int) -> range:
        return range(32 * rank, 32 * rank + 32)


def _check_scan_shape(N: int, H: int) -> None:
    if H % 32 or not 32 <= H <= GRU_SCAN_H_MAX or N < 1:
        raise ValueError(f"gru_scan: the kernel takes H a multiple of 32 from 32 to "
                         f"{GRU_SCAN_H_MAX} and N >= 1; got H={H}, N={N}")


def gru_scan_plan(N: int, H: int, sms: int, max_clusters: Optional[int] = None) -> GruScanPlan:
    """The launch plan of the cluster GRU scan for N rows of hidden size H:
    S = H / 32 CTAs per cluster, R rows per cluster the fewest of 1, 2, 4
    and 8 that keep every cluster resident at once (``max_clusters``,
    default ``sms // S``; the wrapper asks the device), else 8.  H must be
    a multiple of 32 up to ``GRU_SCAN_H_MAX`` (256), where the cluster
    reaches the portable size of 8."""
    _check_scan_shape(N, H)
    S = H // 32
    cap = max(1, max_clusters if max_clusters is not None else sms // S)
    R = next((r for r in (1, 2, 4) if -(-N // r) <= cap), 8)
    smem = 4 * (2 * R * H + S * R * 3 * 32)
    return GruScanPlan(S, R, -(-N // R), H, smem)


@functools.lru_cache(maxsize=None)
def _gru_scan_max_clusters(H: int, device_index: int) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check_rc(_fn("gru_scan", "gru_scan_max_clusters")(H, ctypes.byref(n)),
                  "gru_scan_max_clusters")
    return n.value


# --------------------------------------------------------------------------- #
# The kernels as ``torch.library`` ops
#
# Each kernel is the op ``torch.ops.dpdfnet.<wrapper name>``: its CPU
# implementation is the plain version, its CUDA implementation the kernel's
# launch (checks, plan, launch counter; it raises on what the kernel does
# not take), and its fake implementation gives the output shapes and dtypes
# only.  Eager calls, CUDA graph capture (``runtime.engine``) and
# ``torch.export`` (``export``) then share one dispatch, and a traced
# program holds each kernel as one node.  Every layout switch is an
# argument of the op's schema, never read from the environment inside it,
# so a traced program records the switch it was traced with.  Workspaces a
# launch allocates (intra's fc partials, gru_scan's projections) stay
# inside the op.
#
# The public wrappers keep their arguments: they resolve the switches,
# pack ``dprnn_stack``'s dict into the op's fixed tensor list and run the
# deferred inter tail, around one op call.  They call the plain version
# directly inside ``force_disabled()`` and on the CPU while autograd
# records (the ops have no backward; training takes the plain versions).
# --------------------------------------------------------------------------- #

def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, Tensor) and t.requires_grad for t in tensors)


def _direct(x: Tensor, *tensors) -> bool:
    """Call the plain version itself, not the op: inside
    :func:`force_disabled`, and on the CPU while autograd records through
    ``x`` or ``tensors``."""
    return _plain(x) and (kernels_disabled() or _records(x, *tensors))


def _op_device(what: str, x: Tensor) -> None:
    """A plane neither on the CPU nor on a card (a meta tensor, say) has no
    implementation but the fake one: raise, as the kernel's checks do."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: x is on {x.device}, expected a CUDA tensor")


def _fresh(out: Tensor, *inputs: Tensor) -> Tensor:
    """``out`` contiguous and sharing no storage with ``inputs``: an op's
    outputs may not alias its inputs, and a plain version returns a view
    where its permute or cast is a no-op."""
    out = out.contiguous()
    ptr = out.untyped_storage().data_ptr()
    if any(t is not None and t.untyped_storage().data_ptr() == ptr for t in inputs):
        out = out.clone()
    return out


def _new(like: Tensor, shape, dtype: Optional[torch.dtype] = None) -> Tensor:
    return like.new_empty(tuple(shape), dtype=dtype or like.dtype)


def _register(name: str, cpu, fake, cuda):
    """``torch.ops.dpdfnet.<name>`` with the CPU implementation ``cpu``
    (whose annotations give the schema), ``fake`` and the CUDA launch
    ``cuda``."""
    op = torch.library.custom_op(f"dpdfnet::{name}", cpu, mutates_args=(), device_types="cpu")
    op.register_fake(fake)
    op.register_kernel("cuda", cuda)
    return op


# dprnn_intra_block ------------------------------------------------------------

def _intra_cpu(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor, wfc: Tensor, bfc: Tensor,
               g: Tensor, bln: Tensor, fm_batch: int) -> Tensor:
    return _fresh(dprnn_intra_block_plain(x, wi2, wh2, b2, wfc, bfc, g, bln,
                                          fm_batch=fm_batch or None), x)


def _intra_fake(x, wi2, wh2, b2, wfc, bfc, g, bln, fm_batch):
    if fm_batch:
        Fq, N, C = x.shape
        return _new(x, (N // fm_batch, Fq, fm_batch, C))
    return _new(x, x.shape)


def _intra_cuda(x, wi2, wh2, b2, wfc, bfc, g, bln, fm_batch):
    dev = _require_cuda("dprnn_intra_block", {"x": x},
                        dict(wi2=wi2, wh2=wh2, b2=b2, wfc=wfc, bfc=bfc, g=g, bln=bln))
    if fm_batch:
        Fq, N, C = x.shape
        if fm_batch < 1 or N % fm_batch:
            raise ValueError(f"dprnn_intra_block: fm_batch={fm_batch} does not divide the "
                             f"{N} rows of x {tuple(x.shape)}")
    else:
        N, Fq, C = x.shape
    if C != 64 or tuple(wi2.shape) != (2 * C, 6 * C) or tuple(wh2.shape) != (2 * C, 6 * C) \
            or tuple(b2.shape) != (2, 6 * C) or tuple(wfc.shape) != (2 * C, C):
        raise ValueError(f"dprnn_intra_block: kernel takes C == 64 with packed weights; "
                         f"got x {tuple(x.shape)}, wi2 {tuple(wi2.shape)}")
    _require_aligned("dprnn_intra_block", wi2=wi2, wh2=wh2, wfc=wfc)
    out = (torch.empty((N // fm_batch, Fq, fm_batch, C), device=dev, dtype=x.dtype)
           if fm_batch else torch.empty_like(x))
    plan = intra_plan(N, Fq, _sm_count(dev))
    part = torch.empty((2, N, Fq, C), device=dev, dtype=torch.float32)
    _launch("dprnn_intra_block", dprnn_intra_block, dev,
            _fn("dprnn_intra", "dprnn_intra_launch"),
            x.data_ptr(), out.data_ptr(), part.data_ptr(), wi2.data_ptr(), wh2.data_ptr(),
            b2.data_ptr(), wfc.data_ptr(), bfc.data_ptr(), g.data_ptr(), bln.data_ptr(), N, Fq,
            fm_batch or 0, plan.rows_per_warp, plan.walk_warps, plan.warps, plan.clusters,
            _is_bf16(x))
    return out


_register("dprnn_intra_block", _intra_cpu, _intra_fake, _intra_cuda)


def dprnn_intra_block(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor,
                      wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor, *,
                      fm_batch: Optional[int] = None) -> Tensor:
    """Fused DPRNN intra stage ``x + LN(fc(bidirGRU(x)))`` on ``x [N, Fq, C]``
    (``N = B*T`` rows of the plane, recurrence along Fq, zero state).
    ``fm_batch=B``: the fm chain's layout, ``x [Fq, T*B, C]`` (t-major
    rows) in and ``[T, Fq, B, C]`` out.  Replaces
    ``pallas_gru.dprnn_intra_block`` / ``dprnn_intra_block_tm``."""
    if _direct(x, wi2, wh2, b2, wfc, bfc, g, bln):
        return dprnn_intra_block_plain(x, wi2, wh2, b2, wfc, bfc, g, bln, fm_batch=fm_batch)
    _op_device("dprnn_intra_block", x)
    return torch.ops.dpdfnet.dprnn_intra_block(x, wi2, wh2, b2, wfc, bfc, g, bln,
                                               int(fm_batch or 0))


# dprnn_inter_block ------------------------------------------------------------

def _inter_cpu(x: Tensor, h0: Tensor, wi: Tensor, bi: Tensor, wh: Tensor, bh: Tensor,
               wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor, fm_batch: int, h_bm: bool,
               defer: bool) -> Tuple[Tensor, Tensor]:
    out, h_last = dprnn_inter_block_plain(x, h0, wi, bi, wh, bh, wfc, bfc, g, bln,
                                          fm_batch=fm_batch or None, h_bm=h_bm, defer=defer)
    return _fresh(out, x), _fresh(h_last, h0)


def _inter_fake(x, h0, wi, bi, wh, bh, wfc, bfc, g, bln, fm_batch, h_bm, defer):
    if fm_batch:
        T, N, C = x.shape
        out = _new(x, (N // fm_batch, T, fm_batch, C))
    else:
        out = _new(x, x.shape)
    return out, _new(h0, h0.shape, torch.float32)


def _inter_cuda(x, h0, wi, bi, wh, bh, wfc, bfc, g, bln, fm_batch, h_bm, defer):
    dev = _require_cuda("dprnn_inter_block", {"x": x},
                        dict(h0=h0, wi=wi, bi=bi, wh=wh, bh=bh, wfc=wfc, bfc=bfc, g=g, bln=bln))
    h_bm = bool(h_bm and fm_batch)
    if fm_batch:
        T, N, C = x.shape
        B, Fq = fm_batch, N // max(fm_batch, 1)
        if fm_batch < 1 or N % fm_batch:
            raise ValueError(f"dprnn_inter_block: fm_batch={fm_batch} does not divide the "
                             f"{N} rows of x {tuple(x.shape)}")
        h_shape = (B, Fq, C) if h_bm else (N, C)
        out = torch.empty((Fq, T, B, C), device=dev, dtype=x.dtype)
    else:
        B, T, Fq, C = x.shape
        h_shape = (B, Fq, C)
        out = torch.empty_like(x)
    if C != 64 or tuple(h0.shape) != h_shape or tuple(wi.shape) != (C, 3 * C) \
            or tuple(wh.shape) != (C, 3 * C) or tuple(wfc.shape) != (C, C):
        raise ValueError(f"dprnn_inter_block: kernel takes C == 64 and h0 {h_shape}; got "
                         f"x {tuple(x.shape)}, h0 {tuple(h0.shape)}, wi {tuple(wi.shape)}")
    _require_aligned("dprnn_inter_block", wi=wi, wh=wh, wfc=wfc)
    h_last = torch.empty_like(h0)
    plan = inter_v1_plan(B * Fq, T, _sm_count(dev))
    _launch("dprnn_inter_block", dprnn_inter_block, dev,
            _fn("dprnn_inter", "dprnn_inter_launch"),
            x.data_ptr(), out.data_ptr(), h0.data_ptr(), h_last.data_ptr(), wi.data_ptr(),
            bi.data_ptr(), wh.data_ptr(), bh.data_ptr(), wfc.data_ptr(), bfc.data_ptr(),
            g.data_ptr(), bln.data_ptr(), B, T, Fq, plan.rows_per_warp, plan.ts, plan.warps,
            plan.blocks, _is_bf16(x), int(bool(fm_batch)), int(h_bm), int(bool(defer)))
    return out, h_last


_register("dprnn_inter_block", _inter_cpu, _inter_fake, _inter_cuda)


def dprnn_inter_block(x: Tensor, h0: Tensor, wi: Tensor, bi: Tensor, wh: Tensor,
                      bh: Tensor, wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor, *,
                      fm_batch: Optional[int] = None, h_bm: bool = False,
                      defer: bool = False) -> Tuple[Tensor, Tensor]:
    """Fused DPRNN inter stage on the plane ``x [B, T, Fq, C]`` from the
    carried ``h0 [B, Fq, C]``: ``out[t] = x[t] + LN(fc(GRUstep(h, x[t])))``.
    Returns ``(out, h_last [B, Fq, C])``.

    ``fm_batch=B``: the fm chain's layout, ``x [T, Fq*B, C]`` (f-major
    rows) in, ``out [Fq, T, B, C]``; ``h0`` / ``h_last`` ``[Fq*B, C]`` in
    the rows' order, or ``[B, Fq, C]`` with ``h_bm``.  ``defer``: the
    kernel writes the raw hidden and :func:`inter_tail` runs the fc +
    LayerNorm + residual over the whole plane in PyTorch, x re-read in
    out's layout.  Replaces
    ``pallas_gru.dprnn_inter_block``."""
    T = x.shape[0] if fm_batch else x.shape[1]
    if _direct(x, h0, wi, bi, wh, bh, wfc, bfc, g, bln):
        out, h_last = dprnn_inter_block_plain(x, h0, wi, bi, wh, bh, wfc, bfc, g, bln,
                                              fm_batch=fm_batch, h_bm=h_bm, defer=defer)
    else:
        _op_device("dprnn_inter_block", x)
        out, h_last = torch.ops.dpdfnet.dprnn_inter_block(
            x, h0, wi, bi, wh, bh, wfc, bfc, g, bln, int(fm_batch or 0), bool(h_bm),
            bool(defer))
    if defer:
        x_out = (x.reshape(T, -1, fm_batch, x.shape[-1]).transpose(0, 1) if fm_batch else x)
        out = inter_tail(out, x_out, wfc, bfc, g, bln)
    return out, h_last


# relayout_fm ------------------------------------------------------------------

def _relayout_cpu(x: Tensor, out_dtype: torch.dtype) -> Tensor:
    return _fresh(relayout_fm_plain(x, out_dtype), x)


def _relayout_fake(x, out_dtype):
    B, T, F, C = x.shape
    return _new(x, (F, T, B, C), out_dtype)


def _relayout_cuda(x, out_dtype):
    dev = _require_cuda("relayout_fm", {"x": x}, {})
    if out_dtype not in _PLANE_DTYPES or x.dim() != 4:
        raise ValueError(f"relayout_fm: takes a 4-D plane to float32 or bfloat16; got "
                         f"x {tuple(x.shape)} to {out_dtype}")
    B, T, F, C = x.shape
    out = torch.empty((F, T, B, C), device=dev, dtype=out_dtype)
    if out.numel() == 0:
        return out
    vec = int(C % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
              and out.data_ptr() % (4 * out.element_size()) == 0)
    _launch("relayout_fm", relayout_fm, dev,
            _fn("relayout_fm", "relayout_fm_launch"),
            x.data_ptr(), out.data_ptr(), B, T, F, C, _is_bf16(x), _is_bf16(out), vec)
    return out


_register("relayout_fm", _relayout_cpu, _relayout_fake, _relayout_cuda)


def relayout_fm(x: Tensor, *, out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """The fm chain's entry permute ``x [B, T, F, C] -> [F, T, B, C]``, cast
    to ``out_dtype`` (float32 or bfloat16; default x's) on the store.  Any
    shape (the JAX wrapper's multiple-of-8 fallback is a TPU block limit).
    Replaces ``pallas_gru.relayout_fm``."""
    dtype = x.dtype if out_dtype is None else out_dtype
    if _direct(x):
        return relayout_fm_plain(x, dtype)
    _op_device("relayout_fm", x)
    return torch.ops.dpdfnet.relayout_fm(x, dtype)


# gru_bidir --------------------------------------------------------------------

def _bidir_cpu(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor) -> Tuple[Tensor, Tensor]:
    ys_fw, ys_bw = gru_bidir_plain(x, wi2, wh2, b2)
    return _fresh(ys_fw, x), _fresh(ys_bw, x)


def _bidir_fake(x, wi2, wh2, b2):
    N, L, _ = x.shape
    H = wh2.shape[0] // 2
    return _new(x, (N, L, H)), _new(x, (N, L, H))


def _bidir_cuda(x, wi2, wh2, b2):
    dev = _require_cuda("gru_bidir", {"x": x}, dict(wi2=wi2, wh2=wh2, b2=b2))
    N, L, C = x.shape
    if C != 64 or N == 0 or L == 0 or tuple(wi2.shape) != (2 * C, 6 * C) \
            or tuple(wh2.shape) != (2 * C, 6 * C) or tuple(b2.shape) != (2, 6 * C):
        raise ValueError(f"gru_bidir: kernel takes I == H == 64 with packed weights and "
                         f"N, L > 0; got x {tuple(x.shape)}, wh2 {tuple(wh2.shape)}")
    _require_aligned("gru_bidir", wi2=wi2, wh2=wh2)
    ys_fw = torch.empty_like(x)
    ys_bw = torch.empty_like(x)
    plan = gru_bidir_plan(N, L, _sm_count(dev))
    _launch("gru_bidir", gru_bidir, dev,
            _fn("gru_bidir", "gru_bidir_launch"),
            x.data_ptr(), ys_fw.data_ptr(), ys_bw.data_ptr(), wi2.data_ptr(), wh2.data_ptr(),
            b2.data_ptr(), N, L, plan.rows_per_warp, plan.walk_warps, plan.warps, plan.clusters,
            _is_bf16(x))
    return ys_fw, ys_bw


_register("gru_bidir", _bidir_cpu, _bidir_fake, _bidir_cuda)


def gru_bidir(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """Bidirectional GRU along L of ``x [N, L, I]`` from zero state with
    packed weights; returns ``(ys_fw, ys_bw)``, each ``[N, L, H]``
    (:func:`gru_bidir_plan`).  Replaces ``pallas_gru.gru_bidir_tm``."""
    if _direct(x, wi2, wh2, b2):
        return gru_bidir_plain(x, wi2, wh2, b2)
    _op_device("gru_bidir", x)
    return torch.ops.dpdfnet.gru_bidir(x, wi2, wh2, b2)


# dprnn_stack ------------------------------------------------------------------

_STACK_KEYS = tuple(_stack_shapes(1, 1))


def _stack_cpu(x: Tensor, h0: Tensor, weights: List[Tensor]) -> Tuple[Tensor, Tensor]:
    out, h_last = dprnn_stack_plain(x, h0, dict(zip(_STACK_KEYS, weights)))
    return _fresh(out, x), _fresh(h_last, h0)


def _stack_fake(x, h0, weights):
    return _new(x, x.shape), _new(h0, h0.shape, torch.float32)


def _stack_cuda(x, h0, weights):
    B, T, Fq, C = x.shape
    K = h0.shape[0]
    shapes = _stack_shapes(K, C)
    ws = dict(zip(_STACK_KEYS, weights))
    dev = _require_cuda("dprnn_stack", {"x": x}, dict(h0=h0, **ws))
    bad = [k for k, shape in shapes.items() if tuple(ws[k].shape) != shape]
    if C != 64 or not 1 <= Fq <= _STACK_FQ_MAX or B == 0 or T == 0 or K == 0 \
            or tuple(h0.shape) != (K, B, Fq, C) or bad:
        raise ValueError(f"dprnn_stack: kernel takes C == 64, 1 <= Fq <= {_STACK_FQ_MAX}, "
                         f"B, T, K > 0 and pack_stack weights; got x {tuple(x.shape)}, "
                         f"h0 {tuple(h0.shape)}, misshapen {bad}")
    if any(t.data_ptr() % 16 for t in (x, h0, *ws.values())):
        raise ValueError("dprnn_stack: the kernel reads 16-byte aligned tensors")
    plan = stack_plan(B, Fq, K, _sm_count(dev))
    out = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    _launch("dprnn_stack", dprnn_stack, dev,
            _fn("dprnn_stack", "dprnn_stack_launch"),
            x.data_ptr(), out.data_ptr(), h0.data_ptr(), h_last.data_ptr(),
            *(w.data_ptr() for w in ws.values()), B, T, Fq, K, plan.ctas, plan.threads,
            _is_bf16(x))
    return out, h_last


_register("dprnn_stack", _stack_cpu, _stack_fake, _stack_cuda)


def dprnn_stack(x: Tensor, h0: Tensor, stacked: Dict[str, Tensor]
                ) -> Tuple[Tensor, Tensor]:
    """The whole DPRNN stack over ``x [B, T, Fq, C]`` from the carried
    ``h0 [K, B, Fq, C]`` with ``pack_stack`` weights, in one launch
    (:func:`stack_plan`).  Returns ``(out [B, T, Fq, C], h_last [K, B, Fq,
    C])``; on float32 planes bit-identical to K x (:func:`dprnn_intra_block`
    + :func:`dprnn_inter_block`).  The op takes the weights as a list in
    ``_stack_shapes``' order.  Replaces ``pallas_gru.dprnn_stack``."""
    weights = [stacked[k] for k in _STACK_KEYS]
    if _direct(x, h0, *weights):
        return dprnn_stack_plain(x, h0, stacked)
    _op_device("dprnn_stack", x)
    return torch.ops.dpdfnet.dprnn_stack(x, h0, weights)


# gru_scan ---------------------------------------------------------------------

def _scan_cpu(x: Tensor, h0: Optional[Tensor], wi: Tensor, bi: Tensor, wh: Tensor,
              bh: Tensor, reverse: bool) -> Tuple[Tensor, Tensor]:
    ys, h_last = gru_scan_plain(x, h0, wi, bi, wh, bh, reverse=reverse)
    return _fresh(ys, x), _fresh(h_last, h0)


def _scan_fake(x, h0, wi, bi, wh, bh, reverse):
    N, T, _ = x.shape
    H = wh.shape[0]
    return _new(x, (N, T, H)), _new(x, (N, H), torch.float32)


def _scan_cuda(x, h0, wi, bi, wh, bh, reverse):
    if h0 is None:
        raise ValueError("gru_scan: the kernel takes h0 [N, H]; got None")
    dev = _require_cuda("gru_scan", {"x": x}, dict(h0=h0, wi=wi, bi=bi, wh=wh, bh=bh))
    N, T, I = x.shape
    H = wh.shape[0]
    if tuple(wi.shape) != (I, 3 * H) or tuple(wh.shape) != (H, 3 * H) \
            or tuple(h0.shape) != (N, H) or T < 1:
        raise ValueError(f"gru_scan: kernel takes wi [I, 3H], wh [H, 3H], h0 [N, H] and "
                         f"T >= 1; got x {tuple(x.shape)}, wh {tuple(wh.shape)}")
    _check_scan_shape(N, H)
    plan = gru_scan_plan(N, H, _sm_count(dev), _gru_scan_max_clusters(H, dev.index))
    xp = torch.empty((N, T, 3 * H), device=dev, dtype=torch.float32)
    ys = torch.empty((N, T, H), device=dev, dtype=x.dtype)
    h_last = torch.empty((N, H), device=dev, dtype=torch.float32)
    _launch("gru_scan", gru_scan, dev,
            _fn("gru_scan", "gru_scan_launch"),
            x.data_ptr(), h0.data_ptr(), wi.data_ptr(), bi.data_ptr(), wh.data_ptr(),
            bh.data_ptr(), xp.data_ptr(), ys.data_ptr(), h_last.data_ptr(), N, T, I, H,
            int(reverse), plan.rows_per_cluster, plan.clusters, _is_bf16(x))
    return ys, h_last


_register("gru_scan", _scan_cpu, _scan_fake, _scan_cuda)


def gru_scan(x: Tensor, h0: Tensor, wi: Tensor, bi: Tensor, wh: Tensor, bh: Tensor,
             *, reverse: bool = False) -> Tuple[Tensor, Tensor]:
    """GRU over ``x [N, T, I]`` (batch-major) from ``h0 [N, H]``, forward
    or reverse in time; returns ``(ys [N, T, H], h_last [N, H])``.  The
    kernel takes H a multiple of 32 from 32 to ``GRU_SCAN_H_MAX`` (256,
    every shipped ``gru_dim``) and raises on any other.  Replaces
    ``pallas_gru.gru_scan_tm``."""
    if _direct(x, h0, wi, bi, wh, bh):
        return gru_scan_plain(x, h0, wi, bi, wh, bh, reverse=reverse)
    _op_device("gru_scan", x)
    return torch.ops.dpdfnet.gru_scan(x, h0, wi, bi, wh, bh, bool(reverse))


# dprnn_intra_block_v2 ---------------------------------------------------------

def _intra_v2_cpu(x: Tensor, wi_cat: Tensor, wh_big: Tensor, b2: Tensor, bfc: Tensor,
                  g: Tensor, bln: Tensor, xp_bf16: bool) -> Tensor:
    return _fresh(dprnn_intra_block_v2_plain(x, wi_cat, wh_big, b2, bfc, g, bln,
                                             xp_bf16=xp_bf16), x)


def _intra_v2_fake(x, wi_cat, wh_big, b2, bfc, g, bln, xp_bf16):
    return _new(x, x.shape)


def _intra_v2_cuda(x, wi_cat, wh_big, b2, bfc, g, bln, xp_bf16):
    dev = _require_cuda("dprnn_intra_block_v2", {"x": x},
                        dict(wi_cat=wi_cat, wh_big=wh_big, b2=b2, bfc=bfc, g=g, bln=bln))
    N, L, C = x.shape
    if C != 64 or N == 0 or L == 0 or tuple(wi_cat.shape) != (C, 6 * C) \
            or tuple(wh_big.shape) != (2 * C, 8 * C) or tuple(b2.shape) != (2, 6 * C):
        raise ValueError(f"dprnn_intra_block_v2: kernel takes C == 64 with pack_intra_v2 "
                         f"weights and N, L > 0; got x {tuple(x.shape)}, "
                         f"wh_big {tuple(wh_big.shape)}")
    _require_aligned("dprnn_intra_block_v2", wi_cat=wi_cat, wh_big=wh_big)
    out = torch.empty_like(x)
    plan = intra_plan(N, L, _sm_count(dev))
    lay = intra_v2_layout(C)
    part = torch.empty((2, N, L, C), device=dev, dtype=torch.float32)
    _launch("dprnn_intra_block_v2", dprnn_intra_block_v2, dev,
            _fn("dprnn_intra_v2", "dprnn_intra_v2_launch"),
            x.data_ptr(), out.data_ptr(), part.data_ptr(), wi_cat.data_ptr(), wh_big.data_ptr(),
            b2.data_ptr(), bfc.data_ptr(), g.data_ptr(), bln.data_ptr(), N, L, lay.wi_drow,
            lay.wi_ld, lay.wh_ld, lay.fc_off, lay.fc_doff, lay.fc_ld, plan.rows_per_warp,
            plan.walk_warps, plan.warps, plan.clusters, int(xp_bf16), _is_bf16(x))
    return out


_register("dprnn_intra_block_v2", _intra_v2_cpu, _intra_v2_fake, _intra_v2_cuda)


def dprnn_intra_block_v2(x: Tensor, wi_cat: Tensor, wh_big: Tensor, b2: Tensor,
                         bfc: Tensor, g: Tensor, bln: Tensor, *, xp_bf16: bool = True
                         ) -> Tensor:
    """Fused DPRNN intra stage, v2, on ``x [N, L, C]``: the input
    projections hoisted off the walk (rounded to bfloat16 when ``xp_bf16``,
    the JAX wrapper's default), one product ``h . [Wh2 | blockdiag(Wfc)]``
    per step.  Weights from :func:`pack_intra_v2` plus the v1 ``b2``.  On
    the card this is the intra kernel reading the v2 packs where
    :func:`intra_v2_layout` puts them, with the :func:`intra_plan` plan:
    with ``xp_bf16=False`` its output is bit for bit
    :func:`dprnn_intra_block`'s on the matching v1 packs.  Replaces
    ``pallas_gru.dprnn_intra_block_v2``."""
    if _direct(x, wi_cat, wh_big, b2, bfc, g, bln):
        return dprnn_intra_block_v2_plain(x, wi_cat, wh_big, b2, bfc, g, bln, xp_bf16=xp_bf16)
    _op_device("dprnn_intra_block_v2", x)
    return torch.ops.dpdfnet.dprnn_intra_block_v2(x, wi_cat, wh_big, b2, bfc, g, bln,
                                                  bool(xp_bf16))


# dprnn_inter_block_v2 ---------------------------------------------------------

def _inter_v2_cpu(xp: Tensor, x: Tensor, h0: Tensor, whfc: Tensor, bh: Tensor, bfc: Tensor,
                  g: Tensor, bln: Tensor) -> Tuple[Tensor, Tensor]:
    out, h_last = dprnn_inter_block_v2_plain(xp, x, h0, whfc, bh, bfc, g, bln)
    return _fresh(out, x, xp), _fresh(h_last, h0)


def _inter_v2_fake(xp, x, h0, whfc, bh, bfc, g, bln):
    return _new(x, x.shape), _new(h0, h0.shape, torch.float32)


def _inter_v2_cuda(xp, x, h0, whfc, bh, bfc, g, bln):
    dev = _require_cuda("dprnn_inter_block_v2", {"xp": xp, "x": x},
                        dict(h0=h0, whfc=whfc, bh=bh, bfc=bfc, g=g, bln=bln))
    B, T, Fq, C = x.shape
    if C != 64 or tuple(xp.shape) != (B, T, Fq, 3 * C) or tuple(h0.shape) != (B, Fq, C) \
            or tuple(whfc.shape) != (C, 4 * C) or tuple(bh.shape) != (3 * C,) \
            or B * T * Fq == 0:
        raise ValueError(f"dprnn_inter_block_v2: kernel takes C == 64, xp [B, T, Fq, 3C], "
                         f"whfc [C, 4C] and B, T, Fq > 0; got x {tuple(x.shape)}, "
                         f"xp {tuple(xp.shape)}, whfc {tuple(whfc.shape)}")
    if whfc.data_ptr() % 16:
        raise ValueError("dprnn_inter_block_v2: the kernel reads whfc 16-byte aligned")
    plan = inter_v2_plan(B * Fq, _sm_count(dev))
    out = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    _launch("dprnn_inter_block_v2", dprnn_inter_block_v2, dev,
            _fn("dprnn_inter_v2", "dprnn_inter_v2_launch"),
            xp.data_ptr(), x.data_ptr(), out.data_ptr(), h0.data_ptr(), h_last.data_ptr(),
            whfc.data_ptr(), bh.data_ptr(), bfc.data_ptr(), g.data_ptr(), bln.data_ptr(),
            B, T, Fq, plan.rows_per_warp, plan.warps, plan.blocks, _is_bf16(xp), _is_bf16(x))
    return out, h_last


_register("dprnn_inter_block_v2", _inter_v2_cpu, _inter_v2_fake, _inter_v2_cuda)


def dprnn_inter_block_v2(xp: Tensor, x: Tensor, h0: Tensor, whfc: Tensor, bh: Tensor,
                         bfc: Tensor, g: Tensor, bln: Tensor) -> Tuple[Tensor, Tensor]:
    """Fused DPRNN inter stage, v2, on the plane ``x [B, T, Fq, C]`` from
    ``h0 [B, Fq, C]``, with ``xp [B, T, Fq, 3C] = x . Wi + bi`` computed by
    the caller (float32 or bfloat16) and ``whfc = [Wh | Wfc]``: one product
    ``h_new . [Wh | Wfc]`` per step.  Returns ``(out, h_last [B, Fq, C])``.
    Replaces ``pallas_gru.dprnn_inter_block_v2``."""
    if _direct(x, xp, h0, whfc, bh, bfc, g, bln):
        return dprnn_inter_block_v2_plain(xp, x, h0, whfc, bh, bfc, g, bln)
    _op_device("dprnn_inter_block_v2", x)
    return torch.ops.dpdfnet.dprnn_inter_block_v2(xp, x, h0, whfc, bh, bfc, g, bln)


KERNEL_WRAPPERS = {
    "dprnn_intra_block": dprnn_intra_block,
    "dprnn_inter_block": dprnn_inter_block,
    "gru_scan": gru_scan,
    "gru_bidir": gru_bidir,
    "dprnn_stack": dprnn_stack,
    "dprnn_intra_block_v2": dprnn_intra_block_v2,
    "dprnn_inter_block_v2": dprnn_inter_block_v2,
    "relayout_fm": relayout_fm,
}
for _w in KERNEL_WRAPPERS.values():
    _w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: w.launches for name, w in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
