"""DPDFNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``dpdfnet_tpu`` (JAX/Pallas on TPU), which stays beside it as
the reference.  It carries offline batch enhancement, real-time streaming
and multi-stream serving:

    from dpdfnet_tpu_torch import (Engine, MultiStreamEnhancer, StreamEnhancer,
                                   get_config, init_params)
    cfg = get_config("dpdfnet8_48khz_hr")
    eng = Engine(cfg, init_params(cfg, seed=0))          # runs on cuda
    y = eng.enhance_waveforms(wavs, lengths=lengths)
    se = StreamEnhancer(engine=eng)                      # one live stream
    out = se.process(chunk)                              # any chunk size
    pool = MultiStreamEnhancer(capacity=64, engine=eng)  # many streams

Entry points run on ``cuda`` unless given ``device="cpu"``, and raise when
no GPU is present and the CPU was not asked for.  Importing this package
touches neither CUDA nor ``torch.cuda``; the kernels build with ``nvcc`` on
first use.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

__all__ = ["Engine", "engine_from_quality", "get_config", "init_params",
           "contract_params", "init_state", "forward_spec", "load_params",
           "params_from_jax", "StreamEnhancer", "MultiStreamEnhancer", "__version__"]

_LAZY = {
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
    if name in {"config", "audio"}:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'dpdfnet_tpu_torch' has no attribute {name!r}")
