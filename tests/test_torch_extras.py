"""The port's op zoo against the JAX package's: ``ops/extras.py``,
``ops/multiframe.py``, the plain ``stft`` / ``istft`` and ``count_params``.

Inputs come from numpy seeds; both sides run in float32 (complex64) on the
CPU.  Tolerances: 1e-5 relative to the reference's largest magnitude
(float32 arithmetic in another order, FFTs of other libraries; the
regularised solves of the Wiener / MVDR filters 1e-4, a complex solve's
rounding grows with the system's condition); bit equality for the NumPy
comb-filter matrix and the parameter counts.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import params as jax_params
from dpdfnet_tpu.ops import extras as jx
from dpdfnet_tpu.ops import multiframe as jmf
from dpdfnet_tpu.ops import stft as jstft

from dpdfnet_tpu_torch.config import MODEL_CONFIGS, get_config
from dpdfnet_tpu_torch.models.params import count_params, init_params
from dpdfnet_tpu_torch.ops import extras as tx
from dpdfnet_tpu_torch.ops import multiframe as tmf
from dpdfnet_tpu_torch.ops import stft as tstft
from dpdfnet_tpu_torch.ops.windows import vorbis_window

import torch_testing  # noqa: F401  (the thread budget)

REL = 1e-5


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - ref).max(initial=0.0)) <= rel * scale


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------- #
# extras
# --------------------------------------------------------------------------- #

def test_complex_helpers_and_power_law():
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 7, 2)
    _close(tx.as_real(tx.as_complex(_t(x))).numpy(), x)
    _close(tx.as_complex(_t(x)).numpy(), np.asarray(jx.as_complex(jnp.asarray(x))))
    _close(tx.get_magnitude(_t(x)).numpy(), jx.get_magnitude(jnp.asarray(x)))
    p = np.abs(x) + 1e-3
    _close(tx.to_db(_t(p)).numpy(), jx.to_db(jnp.asarray(p)))
    for alpha in (0.3, 0.6):
        c = tx.power_law_compression(_t(x), alpha)
        _close(c.numpy(), jx.power_law_compression(jnp.asarray(x), alpha))
        _close(tx.power_law_decompression(c, alpha).numpy(), x, rel=1e-5)
        _close(tx.power_law_decompression(_t(x), alpha).numpy(),
               jx.power_law_decompression(jnp.asarray(x), alpha))
    with pytest.raises(ValueError, match="length 2"):
        tx.as_complex(_t(x[..., :1]))


def test_angle_value_and_gradient_through_real_inputs():
    """``angle``'s robust backward against JAX's custom VJP, both taken
    through real re / im inputs (the complex conventions are conjugate),
    with a zero-magnitude element where the clamp engages."""
    rng = np.random.default_rng(1)
    re_, im_ = _rand(rng, 9), _rand(rng, 9)
    re_[0] = im_[0] = 0.0
    w = _rand(rng, 9)

    def jloss(r, i):
        return jnp.sum(jx.angle(jax.lax.complex(r, i)) * w)

    jval = jx.angle(jax.lax.complex(jnp.asarray(re_), jnp.asarray(im_)))
    jgr, jgi = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(re_), jnp.asarray(im_))
    r, i = _t(re_).requires_grad_(True), _t(im_).requires_grad_(True)
    val = tx.angle(torch.complex(r, i))
    (val * _t(w)).sum().backward()
    _close(val.detach().numpy(), jval)
    _close(r.grad.numpy(), jgr)
    _close(i.grad.numpy(), jgi)
    assert np.isfinite(r.grad.numpy()).all() and np.isfinite(i.grad.numpy()).all()


@pytest.mark.parametrize("ws", [1, 4, 5])
def test_local_energy(ws):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 1, 11, 6, 2)
    _close(tx._local_energy(_t(x), ws).numpy(), jx._local_energy(jnp.asarray(x), ws))


@pytest.mark.parametrize("db", [False, True])
def test_local_snr(db):
    rng = np.random.default_rng(3)
    c, n = _rand(rng, 2, 13, 9, 2), _rand(rng, 2, 13, 9, 2, scale=0.3)
    ours = tx.local_snr(_t(c), _t(n), 3, db=db, window_size_ns=5)
    theirs = jx.local_snr(jnp.asarray(c), jnp.asarray(n), 3, db=db, window_size_ns=5)
    for a, b in zip(ours, theirs):
        _close(a.numpy(), b)


@pytest.mark.parametrize("name", ["dpdfnet2", "dpdfnet8_48khz_hr"])
def test_local_snr_target(name):
    cfg = get_config(name)
    rng = np.random.default_rng(4)
    c, n = _rand(rng, 2, 15, cfg.freq_bins, 2), _rand(rng, 2, 15, cfg.freq_bins, 2, scale=0.5)
    kw = dict(fft_size=cfg.n_fft, hop_size=cfg.hop, sr=cfg.sample_rate, ws=20, db=True,
              target_snr_range=(cfg.lsnr_min, cfg.lsnr_max))
    ours, theirs = tx.LocalSnrTarget(**kw), jx.LocalSnrTarget(**kw)
    assert (ours.ws, ours.ws_ns) == (theirs.ws, theirs.ws_ns)
    _close(ours(_t(c), _t(n)).numpy(), theirs(jnp.asarray(c), jnp.asarray(n)))
    # complex input with max_bin: the cut is on the frequency axis
    cc, nc = tx.as_complex(_t(c)), tx.as_complex(_t(n))
    got = ours(cc, nc, max_bin=7)
    _close(got.numpy(), theirs(jnp.asarray(cc.numpy()), jnp.asarray(nc.numpy()), max_bin=7))
    assert tuple(got.shape) == (2, 15)


@pytest.mark.parametrize("kw", [dict(), dict(max_order=2, symmetric=True),
                                dict(output_domain="time", nfft=320, pitch_max=400)])
def test_comb_filter_matrix_equal(kw):
    assert np.array_equal(tx.create_comb_filter_matrix(**kw),
                          jx.create_comb_filter_matrix(**kw))


# --------------------------------------------------------------------------- #
# multiframe
# --------------------------------------------------------------------------- #

B, T, F, N = 2, 9, 11, 3


@pytest.mark.parametrize("lookahead", [0, 1])
def test_spec_unfold_df_crm(lookahead):
    rng = np.random.default_rng(5)
    spec, coefs = _rand(rng, B, T, F, 2), _rand(rng, B, T, N, F, 2)
    su = tmf.spec_unfold(_t(spec), N, lookahead)
    jsu = jmf.spec_unfold(jnp.asarray(spec), N, lookahead)
    _close(su.numpy(), jsu)
    _close(tmf.df(su, _t(coefs)).numpy(), jmf.df(jsu, jnp.asarray(coefs)))
    m = _rand(rng, B, T, F, 2)
    _close(tmf.crm(_t(spec), _t(m)).numpy(), jmf.crm(jnp.asarray(spec), jnp.asarray(m)))


def test_psd_and_tik_reg():
    rng = np.random.default_rng(6)
    x = _rand(rng, B, T, F, 2)
    r = tmf.psd(_t(x), N)
    jr = jmf.psd(jnp.asarray(x), N)
    _close(r.numpy(), jr)
    _close(tmf.tik_reg(r, 1e-3).numpy(), jmf.tik_reg(jr, 1e-3))


def _hermitian_pd(rng, *lead, n):
    a = rng.normal(size=lead + (n, n)) + 1j * rng.normal(size=lead + (n, n))
    h = a @ np.conj(np.swapaxes(a, -1, -2)) + n * np.eye(n)
    return np.stack([h.real, h.imag], -1).astype(np.float32)


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("fn", ["mf_wiener", "mf_mvdr"])
def test_multiframe_filters(fn, inverse):
    rng = np.random.default_rng(7)
    nf = 7
    spec = _rand(rng, B, T, F, 2)
    ifc = _rand(rng, B, T, nf, N, 2)
    mat = _hermitian_pd(rng, B, T, nf, n=N)
    kw = dict(frame_size=N, num_freqs=nf, lookahead=1, inverse=inverse)
    got = getattr(tmf, fn)(_t(spec), _t(ifc), _t(mat), **kw)
    ref = getattr(jmf, fn)(jnp.asarray(spec), jnp.asarray(ifc), jnp.asarray(mat), **kw)
    _close(got.numpy(), ref, rel=1e-4)
    assert np.array_equal(got.numpy()[:, :, nf:], spec[:, :, nf:])


# --------------------------------------------------------------------------- #
# plain STFT / iSTFT, count_params
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("win,hop,vorbis", [(320, 160, True), (512, 128, False)])
def test_plain_stft_istft(win, hop, vorbis, center):
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 4000, scale=0.3)
    w = vorbis_window(win) if vorbis else np.hanning(win + 1)[:-1].astype(np.float32)
    spec = tstft.stft(_t(x), _t(w), hop, center=center)
    jspec = jstft.stft(jnp.asarray(x), jnp.asarray(w), hop, center=center)
    _close(spec.numpy(), jspec)
    y = tstft.istft(spec, _t(w), hop, center=center).numpy()
    jy = np.asarray(jstft.istft(jspec, jnp.asarray(w), hop, center=center))
    assert y.shape == jy.shape
    # causal frames: the first and last win samples are divided by a window
    # sum-square that falls towards 0, which scales any rounding up; hold
    # the fully overlapped samples between them
    edge = 0 if center else win
    _close(y[:, edge: y.shape[1] - edge], jy[:, edge: jy.shape[1] - edge])
    # the plain forms agree with the engine's GEMM forms
    _close(tstft.stft_matmul(_t(x), _t(w), hop, center=center).numpy(), spec.numpy(),
           rel=1e-4)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_count_params(name):
    shapes = jax.eval_shape(lambda: jax_params.init_params(jax_get_config(name), seed=0))
    n = count_params(init_params(get_config(name), seed=0, device="cpu"))
    assert n == jax_params.count_params(shapes)
    assert n > 0
