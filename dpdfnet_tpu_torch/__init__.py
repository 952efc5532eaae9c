"""DPDFNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``dpdfnet_tpu`` (JAX/Pallas on TPU), which stays beside it as
the reference.  It carries the model zoo (reference ``.pth`` checkpoints
converted on first use), offline batch enhancement, real-time streaming,
multi-stream serving, the CLI, the bench runner and training:

    import dpdfnet_tpu_torch as dp
    y = dp.enhance(audio, 48000, model="dpdfnet8_48khz_hr")    # runs on cuda
    dp.enhance_file("in.wav", "out.wav", model="dpdfnet8_48khz_hr")
    se = dp.StreamEnhancer(model="dpdfnet8_48khz_hr")        # one live stream
    out = se.process(chunk)                                   # any chunk size
    pool = dp.MultiStreamEnhancer(64, model="dpdfnet8_48khz_hr")

    python -m dpdfnet_tpu_torch enhance in.wav out.wav --model dpdfnet8_48khz_hr

or from an ``Engine`` built by hand:

    cfg = dp.get_config("dpdfnet8_48khz_hr")
    eng = dp.Engine(cfg, dp.init_params(cfg, seed=0))
    y = eng.enhance_waveforms(wavs, lengths=lengths)
    se = dp.StreamEnhancer(engine=eng)

    from dpdfnet_tpu_torch import train          # losses and a train step
    params = dp.init_params(cfg, seed=0)         # or zoo.load_model_params(...)
    opt = torch.optim.Adam(train.trainable_parameters(params), lr=1e-3)
    loss, aux = train.make_train_step(cfg, opt)(params, noisy, clean)

Entry points run on ``cuda`` unless given ``device="cpu"`` (``--device
cpu``), and raise when no GPU is present and the CPU was not asked for.
Importing this package touches neither CUDA nor ``torch.cuda``; the
kernels build with ``nvcc`` on first use.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

__all__ = ["enhance", "enhance_file", "enhance_batch", "available_models", "download",
           "Engine", "engine_from_quality", "get_config", "init_params",
           "contract_params", "init_state", "forward_spec", "load_params",
           "params_from_jax", "StreamEnhancer", "MultiStreamEnhancer", "__version__"]

_LAZY = {
    "enhance": ".api",
    "enhance_file": ".api",
    "enhance_batch": ".api",
    "available_models": ".api",
    "download": ".api",
    "Engine": ".runtime.engine",
    "engine_from_quality": ".runtime.engine",
    "get_config": ".config",
    "init_params": ".models.params",
    "contract_params": ".models.params",
    "init_state": ".models.state",
    "forward_spec": ".models.dpdfnet",
    "load_params": ".utils.serialization",
    "params_from_jax": ".utils.serialization",
    "StreamEnhancer": ".stream",
    "MultiStreamEnhancer": ".serving",
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    if name in {"config", "audio", "audio_io", "zoo", "metrics", "demo", "serving", "train"}:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'dpdfnet_tpu_torch' has no attribute {name!r}")
