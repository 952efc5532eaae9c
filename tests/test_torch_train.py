"""The port's training path against the JAX package's: the losses,
``enhancement_loss`` with every gradient leaf, Adam steps, the frozen ERB
filterbanks, ``force_disabled`` scoping and the train step's API.

Weights: random contracted weights (``init_params`` + ``contract_params``)
as numpy arrays, fed to the JAX functions and carried into the port with
``params_from_jax``.  They are drawn by the port's ``init_params``, whose
tree and shapes are the JAX package's (``test_torch_package.py``): the JAX
package's eager ``init_params`` spends about 15 s in CPU compiles per test
module.  Inputs come from numpy seeds (the tone plus noise of
``tests/test_train.py``).  JAX differentiates its plain
scan path on the CPU (``pallas_gru.enabled()`` is false off the TPU) under
``highest`` matmul precision; the port runs on ``device="cpu"``, where
every kernel wrapper takes its plain version.  One jitted JAX
``value_and_grad`` per config, cached.

Tolerances:
- each loss and ``enhancement_loss``'s value: 1e-5 relative (float32 in
  another summation order; measured about 2e-7);
- every gradient leaf: max-abs deviation over the leaf's largest JAX
  magnitude at most 1e-4 (measured at most 8e-7 on dpdfnet2 and 2e-6 on
  dpdfnet8_48khz_hr, over 13 and 7 frames of recurrences);
- three Adam steps against three ``optax.adam(1e-3)`` steps on JAX's
  gradients with the JAX step's frozen filterbanks: each loss within 1e-4
  relative (Adam's first steps move every weight by about lr whatever its
  gradient's size, so a tiny gradient's rounding moves the weights more
  than it moves the loss).
"""

import functools
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from dpdfnet_tpu import train as jax_train
from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.ops import stft as jax_stft
from dpdfnet_tpu.ops.windows import vorbis_window

from dpdfnet_tpu_torch import train
from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models.params import count_params
from dpdfnet_tpu_torch.ops import gru_kernels
from dpdfnet_tpu_torch.ops import stft as tstft
from dpdfnet_tpu_torch.utils.serialization import params_from_jax
from dpdfnet_tpu_torch.utils.tree import tree_leaves

from torch_testing import port_params_np

LOSS_REL = 1e-5
GRAD_REL = 1e-4
ADAM_REL = 1e-4
SECONDS = {"dpdfnet2": 0.12, "dpdfnet8_48khz_hr": 0.06}


def _wavs(name, seed=0):
    cfg = get_config(name)
    rng = np.random.default_rng(seed)
    n = int(SECONDS[name] * cfg.sample_rate)
    clean = (0.2 * np.sin(2 * np.pi * 300 * np.arange(n) / cfg.sample_rate)
             ).astype(np.float32)[None]
    noisy = clean + 0.1 * rng.normal(size=clean.shape).astype(np.float32)
    return noisy, clean


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    return jax.jit(jax.value_and_grad(jax_train.enhancement_loss, has_aux=True),
                   static_argnums=1)


def _jax_loss_and_grads(name, params):
    noisy, clean = _wavs(name)
    with jax.default_matmul_precision("highest"):
        (loss, aux), grads = _jax_value_and_grad(name)(
            params, jax_get_config(name), jnp.asarray(noisy), jnp.asarray(clean))
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_leaves(jax.tree_util.tree_map(np.asarray, tree))}


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #

def test_losses_match_jax():
    cfg, jcfg = get_config("dpdfnet2"), jax_get_config("dpdfnet2")
    rng = np.random.default_rng(3)
    clean = (0.2 * rng.normal(size=(2, 4800))).astype(np.float32)
    est = clean + (0.05 * rng.normal(size=clean.shape)).astype(np.float32)
    w = vorbis_window(cfg.win_len)
    lsnr = rng.uniform(-15, 35, size=(2, 4800 // cfg.hop + 1)).astype(np.float32)

    @jax.jit                         # one compile, not one per eager op
    def jax_losses(est, clean, lsnr):
        jse = jax_stft.stft(est, jnp.asarray(w), cfg.hop) * cfg.wnorm
        jsc = jax_stft.stft(clean, jnp.asarray(w), cfg.hop) * cfg.wnorm
        return (jax_train.si_snr_loss(est, clean),
                jax_train.multi_res_spectral_loss(est, clean),
                jax_train.spectral_loss(jse, jsc),
                jax_train.spectral_loss(jse, jsc, compression=0.3, factor_complex=0.5,
                                        factor_magnitude=2.0),
                jax_train.lsnr_loss(lsnr, jsc, jse - jsc, jcfg))

    te, tc = torch.from_numpy(est), torch.from_numpy(clean)
    se = tstft.stft(te, torch.from_numpy(w), cfg.hop) * cfg.wnorm
    sc = tstft.stft(tc, torch.from_numpy(w), cfg.hop) * cfg.wnorm
    ours = (train.si_snr_loss(te, tc), train.multi_res_spectral_loss(te, tc),
            train.spectral_loss(se, sc),
            train.spectral_loss(se, sc, compression=0.3, factor_complex=0.5,
                                factor_magnitude=2.0),
            train.lsnr_loss(torch.from_numpy(lsnr), sc, se - sc, cfg))
    with jax.default_matmul_precision("highest"):
        theirs = jax_losses(jnp.asarray(est), jnp.asarray(clean), jnp.asarray(lsnr))
    for a, b in zip(ours, theirs):
        assert _rel(a, b) <= LOSS_REL
    assert float(train.spectral_loss(sc, sc)) < 1e-10
    assert float(train.si_snr_loss(tc, tc)) < -50


# --------------------------------------------------------------------------- #
# enhancement_loss and its gradients
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["dpdfnet2", "dpdfnet8_48khz_hr"])
def test_enhancement_loss_and_every_gradient_match_jax(name):
    pj = port_params_np(name, seed=0)
    jloss, jaux, jgrads = _jax_loss_and_grads(name, pj)
    p = params_from_jax(pj, device="cpu")
    leaves = [(k, x.requires_grad_(True)) for k, x in tree_leaves(p)]
    noisy, clean = _wavs(name)
    loss, aux = train.enhancement_loss(p, get_config(name), torch.from_numpy(noisy),
                                       torch.from_numpy(clean))
    grads = torch.autograd.grad(loss, [x for _, x in leaves], allow_unused=True)
    assert _rel(loss.detach(), jloss) <= LOSS_REL
    for k in ("spec", "lsnr"):
        assert _rel(aux[k].detach(), jaux[k]) <= LOSS_REL
    ref = _flat(jgrads)
    assert {k for k, _ in leaves} == set(ref)
    for (k, x), g in zip(leaves, grads):
        # hr configs do not use the ERB filterbanks: no grad here, zeros in JAX
        got = np.zeros_like(ref[k]) if g is None else g.numpy()
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        assert np.isfinite(got).all(), k
        assert float(np.abs(got - ref[k]).max()) <= GRAD_REL * scale, k
    used = sum(g is not None and float(g.abs().sum()) > 0 for g in grads)
    assert used / len(grads) > 0.9


def test_adam_steps_match_optax_and_lower_the_loss():
    name = "dpdfnet2"
    cfg = get_config(name)
    noisy, clean = _wavs(name)
    # JAX: make_train_step's update (frozen filterbank grads and updates)
    # on the cached jitted gradients
    opt = optax.adam(1e-3)

    @jax.jit
    def update(grads, state, params):
        updates, state = opt.update(jax_train._freeze_buffers(grads), state, params)
        return optax.apply_updates(params, jax_train._freeze_buffers(updates)), state

    pj = jax.tree_util.tree_map(jnp.asarray, port_params_np(name, seed=0))
    state = opt.init(pj)
    jax_losses = []
    for _ in range(3):
        loss, _, grads = _jax_loss_and_grads(name, pj)
        pj, state = update(grads, state, pj)
        jax_losses.append(loss)
    # the port
    p = params_from_jax(port_params_np(name, seed=0), device="cpu")
    fb = p["erb_fb"].clone()
    step = train.make_train_step(cfg, torch.optim.Adam(train.trainable_parameters(p), lr=1e-3))
    losses = [float(step(p, torch.from_numpy(noisy), torch.from_numpy(clean))[0])
              for _ in range(3)]
    for a, b in zip(losses, jax_losses):
        assert _rel(a, b) <= ADAM_REL
    assert losses[-1] < losses[0]
    assert torch.equal(p["erb_fb"], fb) and not p["erb_fb"].requires_grad


def test_adamw_leaves_the_filterbanks_bit_unchanged():
    name = "dpdfnet2"
    cfg = get_config(name)
    noisy, clean = _wavs(name)
    p = params_from_jax(port_params_np(name, seed=0), device="cpu")
    before = {k: x.clone() for k, x in tree_leaves(p)}
    trainable = train.trainable_parameters(p)
    assert sum(x.numel() for x in trainable) == count_params(p)
    step = train.make_train_step(
        cfg, torch.optim.AdamW(trainable, lr=1e-3, weight_decay=0.5))
    loss, aux = step(p, torch.from_numpy(noisy), torch.from_numpy(clean))
    assert not loss.requires_grad and set(aux) == {"spec", "lsnr"}
    after = dict(tree_leaves(p))
    for k in ("erb_fb", "erb_inv_fb"):
        assert torch.equal(after[k], before[k]) and not after[k].requires_grad
    assert not torch.equal(after["enc/erb_conv0/w"], before["enc/erb_conv0/w"])


def test_train_step_rejects_a_trained_filterbank_and_a_mesh():
    cfg = get_config("dpdfnet2")
    p = params_from_jax(port_params_np("dpdfnet2", seed=0), device="cpu")
    opt = torch.optim.SGD([x.requires_grad_(True) for _, x in tree_leaves(p)], lr=1e-3)
    noisy, clean = _wavs("dpdfnet2")
    with pytest.raises(ValueError, match="erb_fb"):
        train.make_train_step(cfg, opt)(p, torch.from_numpy(noisy), torch.from_numpy(clean))
    # a batch the mesh cannot split raises, as the JAX step's in_shardings do
    from dpdfnet_tpu_torch.parallel.mesh import make_mesh

    p = params_from_jax(port_params_np("dpdfnet2", seed=0), device="cpu")
    opt = torch.optim.SGD(train.trainable_parameters(p), lr=1e-3)
    wav3 = torch.from_numpy(np.tile(noisy, (3, 1)))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        train.make_train_step(cfg, opt, mesh=make_mesh(["cpu"] * 2))(p, wav3, wav3)


# --------------------------------------------------------------------------- #
# force_disabled
# --------------------------------------------------------------------------- #

def _meta_gru():
    """A GRU scan on the meta device, which stands for a card here: no CPU
    tensor, so only ``force_disabled`` routes it to the plain version."""
    H = 32
    return dict(x=torch.empty(2, 3, H, device="meta"), h0=torch.empty(2, H, device="meta"),
                wi=torch.empty(H, 3 * H, device="meta"), bi=torch.empty(3 * H, device="meta"),
                wh=torch.empty(H, 3 * H, device="meta"), bh=torch.empty(3 * H, device="meta"))


def test_force_disabled_routes_off_cpu_tensors_to_the_plain_version():
    args = _meta_gru()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        gru_kernels.gru_scan(**args)                    # outside: the kernel or a raise
    before = gru_kernels.launch_counts()
    with gru_kernels.force_disabled():
        ys, h = gru_kernels.gru_scan(**args)
    assert ys.device.type == "meta" and tuple(ys.shape) == (2, 3, 32)
    assert gru_kernels.launch_counts() == before


def test_force_disabled_nests_and_is_per_thread():
    x = torch.empty(1, device="meta")
    assert not gru_kernels._plain(x)
    seen = {}

    def probe():
        seen["thread"] = gru_kernels._plain(x)

    with gru_kernels.force_disabled():
        with gru_kernels.force_disabled():
            assert gru_kernels._plain(x)
        assert gru_kernels._plain(x)                    # the outer block still holds
        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen["thread"] is False                     # another thread keeps its kernels
    assert not gru_kernels._plain(x)
    assert gru_kernels._plain(torch.empty(1))          # the CPU always takes the plain path
