"""The port's sequential kernels: DPRNN intra, DPRNN inter, GRU scan.

Counterpart of ``dpdfnet_tpu.ops.pallas_gru``.  Each wrapper sits beside
its plain PyTorch version:

- for a tensor on the CPU the wrapper runs the plain version (that is what
  the CPU tests exercise);
- for a CUDA tensor it launches the hand-written CUDA kernel
  (``csrc/*.cu``, built for ``sm_90a`` by ``_build``) or raises.  There is
  no fallback.

Every wrapper carries a launch counter, ``<wrapper>.launches``, raised by
one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels (``launch_counts`` /
``reset_launch_counts``).

Layouts follow the port's planes, not the TPU's time-major ones: the
kernels read ``[B, T, Fq, C]`` through strides.  Weight argument lists are
the JAX wrappers': packed ``wi2, wh2, b2`` for intra, ``wi, bi, wh, bh,
wfc, bfc, g, bln`` for inter.  The CUDA kernels compute in float32 and
take DPRNN planes with ``C == 64`` (every shipped configuration).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .nn import gru_cell

Tensor = torch.Tensor

_LN_EPS = 1e-5


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
    returns ``(ys [N, T, H], h_last [N, H])``."""
    N, T, _ = x.shape
    H = wh.shape[0]
    h = x.new_zeros((N, H)) if h0 is None else h0.to(x.dtype)
    xp = x @ wi + bi                                            # [N, T, 3H]
    ys = [None] * T
    for s in range(T):
        t = T - 1 - s if reverse else s
        h = gru_cell({"wh": wh, "bh": bh}, xp[:, t], h)
        ys[t] = h
    return torch.stack(ys, dim=1), h


def dprnn_intra_block_plain(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor,
                            wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor
                            ) -> Tensor:
    """``x + LN(fc(bidirGRU_along_Fq(x)))`` over ``x [N, Fq, C]`` with the
    packed direction-blockdiag weights (``models.fuse._pack_bidir``)."""
    N, Fq, C = x.shape
    C2 = 2 * C
    h = x.new_zeros((N, C2))
    ys_f, ys_b = [None] * Fq, [None] * Fq
    for s in range(Fq):
        x2 = torch.cat([x[:, s], x[:, Fq - 1 - s]], dim=-1)
        xp = x2 @ wi2 + b2[0]
        hh = h @ wh2 + b2[1]
        r = torch.sigmoid(xp[:, :C2] + hh[:, :C2])
        z = torch.sigmoid(xp[:, C2:2 * C2] + hh[:, C2:2 * C2])
        n = torch.tanh(xp[:, 2 * C2:] + r * hh[:, 2 * C2:])
        h = (1.0 - z) * n + z * h
        ys_f[s] = h[:, :C]
        ys_b[Fq - 1 - s] = h[:, C:]
    ys = torch.cat([torch.stack(ys_f, 1), torch.stack(ys_b, 1)], dim=-1)
    return x + _ln(ys @ wfc + bfc, g, bln)


def dprnn_inter_block_plain(x: Tensor, h0: Tensor, wi: Tensor, bi: Tensor,
                            wh: Tensor, bh: Tensor, wfc: Tensor, bfc: Tensor,
                            g: Tensor, bln: Tensor) -> Tuple[Tensor, Tensor]:
    """GRU along T for every (b, f) row of ``x [B, T, Fq, C]`` from
    ``h0 [B, Fq, C]``; ``out[t] = x[t] + LN(fc(h_t))``.  Returns
    ``(out [B, T, Fq, C], h_last [B, Fq, C])``."""
    B, T, Fq, C = x.shape
    xt = x.transpose(1, 2).reshape(B * Fq, T, C)
    ys, hl = gru_scan_plain(xt, h0.reshape(B * Fq, C), wi, bi, wh, bh)
    y = _ln(ys @ wfc + bfc, g, bln)
    return x + y.reshape(B, Fq, T, C).transpose(1, 2), hl.reshape(B, Fq, C)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "dprnn_inter_launch": [_P] * 12 + [_I] * 4 + [_P],
    "dprnn_intra_launch": [_P] * 10 + [ctypes.c_longlong, _I, _I, _P],
    "gru_scan_launch": [_P] * 9 + [_I] * 6 + [_P],
}


def _fn(lib_name: str, fn_name: str):
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require_cuda(what: str, **tensors: Tensor) -> torch.device:
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    return dev


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _walk_rows_per_block(rows: int, blocks_per_row_tile: int, dev) -> int:
    """8 rows per block while 16 would leave SMs idle, else 16."""
    return 16 if -(-rows // 16) * blocks_per_row_tile >= _sm_count(dev) else 8


def dprnn_intra_block(x: Tensor, wi2: Tensor, wh2: Tensor, b2: Tensor,
                      wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor) -> Tensor:
    """Fused DPRNN intra stage ``x + LN(fc(bidirGRU(x)))`` on ``x [N, Fq, C]``
    (``N = B*T`` rows of the plane, recurrence along Fq, zero state).
    Replaces ``pallas_gru.dprnn_intra_block`` / ``dprnn_intra_block_tm``."""
    if x.device.type == "cpu":
        return dprnn_intra_block_plain(x, wi2, wh2, b2, wfc, bfc, g, bln)
    dev = _require_cuda("dprnn_intra_block", x=x, wi2=wi2, wh2=wh2, b2=b2, wfc=wfc,
                        bfc=bfc, g=g, bln=bln)
    N, Fq, C = x.shape
    if C != 64 or tuple(wi2.shape) != (2 * C, 6 * C) or tuple(wh2.shape) != (2 * C, 6 * C) \
            or tuple(b2.shape) != (2, 6 * C) or tuple(wfc.shape) != (2 * C, C):
        raise ValueError(f"dprnn_intra_block: kernel takes C == 64 with packed weights; "
                         f"got x {tuple(x.shape)}, wi2 {tuple(wi2.shape)}")
    out = torch.empty_like(x)
    part = torch.empty((2, N, Fq, C), device=dev, dtype=torch.float32)
    rc = _fn("dprnn_intra", "dprnn_intra_launch")(
        x.data_ptr(), out.data_ptr(), part.data_ptr(), wi2.data_ptr(), wh2.data_ptr(),
        b2.data_ptr(), wfc.data_ptr(), bfc.data_ptr(), g.data_ptr(), bln.data_ptr(),
        N, Fq, _walk_rows_per_block(N, 2, dev), _stream())
    _check_rc(rc, "dprnn_intra_block")
    dprnn_intra_block.launches += 1
    return out


def dprnn_inter_block(x: Tensor, h0: Tensor, wi: Tensor, bi: Tensor, wh: Tensor,
                      bh: Tensor, wfc: Tensor, bfc: Tensor, g: Tensor, bln: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """Fused DPRNN inter stage on the plane ``x [B, T, Fq, C]`` from the
    carried ``h0 [B, Fq, C]``: ``out[t] = x[t] + LN(fc(GRUstep(h, x[t])))``.
    Returns ``(out, h_last [B, Fq, C])``.  Replaces
    ``pallas_gru.dprnn_inter_block``."""
    if x.device.type == "cpu":
        return dprnn_inter_block_plain(x, h0, wi, bi, wh, bh, wfc, bfc, g, bln)
    dev = _require_cuda("dprnn_inter_block", x=x, h0=h0, wi=wi, bi=bi, wh=wh, bh=bh,
                        wfc=wfc, bfc=bfc, g=g, bln=bln)
    B, T, Fq, C = x.shape
    if C != 64 or tuple(h0.shape) != (B, Fq, C) or tuple(wi.shape) != (C, 3 * C) \
            or tuple(wh.shape) != (C, 3 * C) or tuple(wfc.shape) != (C, C):
        raise ValueError(f"dprnn_inter_block: kernel takes C == 64; got x {tuple(x.shape)}, "
                         f"h0 {tuple(h0.shape)}, wi {tuple(wi.shape)}")
    out = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    rc = _fn("dprnn_inter", "dprnn_inter_launch")(
        x.data_ptr(), out.data_ptr(), h0.data_ptr(), h_last.data_ptr(), wi.data_ptr(),
        bi.data_ptr(), wh.data_ptr(), bh.data_ptr(), wfc.data_ptr(), bfc.data_ptr(),
        g.data_ptr(), bln.data_ptr(), B, T, Fq, _walk_rows_per_block(B * Fq, 1, dev),
        _stream())
    _check_rc(rc, "dprnn_inter_block")
    dprnn_inter_block.launches += 1
    return out, h_last


def gru_scan(x: Tensor, h0: Tensor, wi: Tensor, bi: Tensor, wh: Tensor, bh: Tensor,
             *, reverse: bool = False) -> Tuple[Tensor, Tensor]:
    """GRU over ``x [N, T, I]`` (batch-major) from ``h0 [N, H]``, forward
    or reverse in time; returns ``(ys [N, T, H], h_last [N, H])``.
    Replaces ``pallas_gru.gru_scan_tm``."""
    if x.device.type == "cpu":
        return gru_scan_plain(x, h0, wi, bi, wh, bh, reverse=reverse)
    dev = _require_cuda("gru_scan", x=x, h0=h0, wi=wi, bi=bi, wh=wh, bh=bh)
    N, T, I = x.shape
    H = wh.shape[0]
    if H % 32 or H > 1024 or tuple(wi.shape) != (I, 3 * H) or tuple(wh.shape) != (H, 3 * H) \
            or tuple(h0.shape) != (N, H):
        raise ValueError(f"gru_scan: kernel takes H a multiple of 32 up to 1024 with "
                         f"wi [I, 3H], wh [H, 3H]; got x {tuple(x.shape)}, wh {tuple(wh.shape)}")
    xp = torch.empty((N, T, 3 * H), device=dev, dtype=torch.float32)
    ys = torch.empty((N, T, H), device=dev, dtype=torch.float32)
    h_last = torch.empty((N, H), device=dev, dtype=torch.float32)
    sms = _sm_count(dev)
    rpb = next((r for r in (1, 2, 4) if -(-N // r) <= sms), 8)
    rc = _fn("gru_scan", "gru_scan_launch")(
        x.data_ptr(), h0.data_ptr(), wi.data_ptr(), bi.data_ptr(), wh.data_ptr(),
        bh.data_ptr(), xp.data_ptr(), ys.data_ptr(), h_last.data_ptr(), N, T, I, H,
        int(reverse), rpb, _stream())
    _check_rc(rc, "gru_scan")
    gru_scan.launches += 1
    return ys, h_last


KERNEL_WRAPPERS = {
    "dprnn_intra_block": dprnn_intra_block,
    "dprnn_inter_block": dprnn_inter_block,
    "gru_scan": gru_scan,
}
for _w in KERNEL_WRAPPERS.values():
    _w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: w.launches for name, w in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
