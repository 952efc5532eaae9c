"""Multi-frame filtering: deep filtering, Wiener, MVDR, complex ratio mask
(counterpart of ``dpdfnet_tpu.ops.multiframe``).

The DPDFNet forward runs its own deep filter (``models.dpdfnet._apply_df``);
the multi-frame Wiener filter and MVDR beamformer are carried for the
reference's op zoo.  They work on externally estimated (inverse)
correlation matrices and inter-frame correlation vectors.  Complex
quantities are ``[..., 2]`` real / imaginary stacks at the interfaces, as
in the rest of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _c(x: Tensor) -> Tensor:
    return torch.complex(x[..., 0], x[..., 1])


def _r(x: Tensor) -> Tensor:
    return torch.stack([x.real, x.imag], dim=-1)


def spec_unfold(spec: Tensor, frame_size: int, lookahead: int = 0) -> Tensor:
    """Pad and unfold a spectrogram over time: ``[B, T, F, 2] -> [B, T, N,
    F, 2]``, window ``n`` covering frame ``t - (N-1-lookahead) + n``."""
    T = spec.shape[1]
    pad_l = frame_size - 1 - lookahead
    ext = F.pad(spec, (0, 0, 0, 0, pad_l, lookahead))
    return torch.stack([ext[:, n: n + T] for n in range(frame_size)], dim=2)


def df(spec_unfolded: Tensor, coefs: Tensor) -> Tensor:
    """Deep filtering, a complex multiply-accumulate over the frame axis:
    ``[B, T, N, F, 2]`` x ``[B, T, N, F, 2] -> [B, T, F, 2]``."""
    return _r((_c(spec_unfolded) * _c(coefs)).sum(dim=2))


def psd(x: Tensor, n: int) -> Tensor:
    """Per-frame correlation matrices over an n-frame causal unfold:
    ``[B, T, F, 2] -> [B, T, F, N, N, 2]`` with ``R[m, n] = x_n conj(x_m)``
    (the outer product, no sum over frames)."""
    xu = _c(spec_unfold(x, n, lookahead=0)).movedim(2, -1)         # [B, T, F, N]
    return _r(torch.einsum("...n,...m->...mn", xu, xu.conj()))


def tik_reg(mat: Tensor, reg: float = 1e-7, eps: float = 1e-8) -> Tensor:
    """Tikhonov regularisation on the real part of the diagonal
    (torchaudio's ``_tik_reg``)."""
    m = _c(mat)
    n = m.shape[-1]
    trace = torch.diagonal(m, dim1=-2, dim2=-1).sum(dim=-1).real[..., None, None]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    return _r(m + (trace * reg + eps) * eye)


def crm(spec: Tensor, coefs: Tensor) -> Tensor:
    """Complex ratio mask: a complex multiply per bin."""
    return _r(_c(spec) * _c(coefs))


def _unfolded_lower(spec: Tensor, frame_size: int, num_freqs: int, lookahead: int
                    ) -> Tensor:
    """The unfolded spectrum's lowest ``num_freqs`` bins, ``[B, T, F', N]``
    complex."""
    su = _c(spec_unfold(spec, frame_size, lookahead)).movedim(2, -1)
    return su[..., :num_freqs, :]


def _weights(a: Tensor, v: Tensor, inverse: bool, dload: float, eps: float) -> Tensor:
    """``a v`` for an inverse matrix ``a``, else the solve of the
    regularised system."""
    if inverse:
        return torch.einsum("...nm,...m->...n", a, v)
    a = _c(tik_reg(_r(a), dload, eps))
    return torch.linalg.solve(a, v[..., None])[..., 0]


def mf_wiener(spec: Tensor, ifc: Tensor, irxx: Tensor, *, frame_size: int,
              num_freqs: int, lookahead: int = 0, inverse: bool = True,
              eps: float = 1e-8, dload: float = 1e-7) -> Tensor:
    """Multi-frame Wiener filter (reference ``MfWf.forward``).

    ``spec [B, T, F, 2]`` noisy spectrogram; ``ifc [B, T, F', N, 2]``
    inter-frame speech correlation vector; ``irxx [B, T, F', N, N, 2]`` the
    inverse noisy covariance, or with ``inverse=False`` the covariance
    itself, whose regularised system is then solved.  Returns the filtered
    ``[B, T, F, 2]``; bins from ``num_freqs`` up pass through."""
    su = _unfolded_lower(spec, frame_size, num_freqs, lookahead)
    w = _weights(_c(irxx), _c(ifc), inverse, dload, eps)
    out = torch.einsum("...n,...n->...", su, w)                    # [B, T, F']
    return torch.cat([_r(out), spec[:, :, num_freqs:]], dim=2)


def mf_mvdr(spec: Tensor, ifc: Tensor, irnn: Tensor, *, frame_size: int,
            num_freqs: int, lookahead: int = 0, inverse: bool = True,
            eps: float = 1e-8, dload: float = 1e-7) -> Tensor:
    """Multi-frame MVDR beamformer (reference ``MfMvdr.forward``)."""
    su = _unfolded_lower(spec, frame_size, num_freqs, lookahead)
    v = _c(ifc)
    num = _weights(_c(irnn), v, inverse, dload, eps)
    den = torch.einsum("...n,...n->...", v.conj(), num)
    w = num * v[..., -1:].conj() / (den.real[..., None] + eps)
    out = torch.einsum("...n,...n->...", su, w)
    return torch.cat([_r(out), spec[:, :, num_freqs:]], dim=2)
