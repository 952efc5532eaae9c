"""The offline call with its padding, cut and zeroing on the host, as
``Engine.enhance_waveforms`` ran them before they moved to the device.

The batch is zero-padded into a host array (to ``bucket_len(S)`` samples,
and on a mesh to a multiple of its size with zero rows), each replica's
rows are uploaded from pageable memory, each replica's
``Engine._offline_rows`` runs the same schedule, one replica after
another in the calling thread, the whole padded output comes back, and
the host cuts it into ``np.zeros_like`` and zeroes each row past its
length in a loop.
The tests hold the engine's output to this path bit for bit.  It imports
neither JAX nor the JAX package, so the card's tests use it too.
"""

import numpy as np
import torch

from dpdfnet_tpu_torch import audio as audio_lib
from dpdfnet_tpu_torch.runtime.engine import _math_mode


def enhance_host_padded(eng, wavs, attn_limit_db=None, lengths=None):
    """``eng.enhance_waveforms(wavs, attn_limit_db, lengths)`` through the
    host-side pad, fetch and cut."""
    value = audio_lib.validate_attn_limit_db(attn_limit_db)
    alpha = 0.0 if value is None else float(np.float32(10.0 ** (-value / 20.0)))
    squeeze = np.ndim(wavs) == 1
    x = np.atleast_2d(np.asarray(wavs, dtype=np.float32))
    B, S = x.shape
    S_pad = eng.bucket_len(S)
    n_seg = int(eng._bucket_segments(S))
    n = len(eng.replicas)
    xp = np.zeros((-(-B // n) * n, S_pad), np.float32)
    xp[:B, :S] = x
    b = xp.shape[0] // n
    need = np.zeros(xp.shape[0], np.int64)
    if lengths is None:
        need[:B] = n_seg
    else:
        ln = np.clip(np.asarray(lengths, np.int64).reshape(-1), 0, S)
        need[:B] = np.where(ln > 0, eng._bucket_segments(ln), 0)
    ys = []
    with _math_mode(eng.precision), torch.inference_mode():
        for j, rep in enumerate(eng.replicas):
            nj = need[j * b:(j + 1) * b]
            order = np.argsort(-nj, kind="stable")
            ys.append(rep._offline_rows(
                torch.from_numpy(xp[j * b:(j + 1) * b]).to(rep.device), alpha,
                None if (order == np.arange(b)).all() else torch.from_numpy(order).to(rep.device),
                [int(np.count_nonzero(nj > i)) for i in range(n_seg)]))
    parts = [y.cpu().numpy() for y in ys]
    y = parts[0] if len(parts) == 1 else np.concatenate(parts)
    out = np.zeros_like(x)
    m = min(S, y.shape[1])
    out[:, :m] = y[:B, :m]
    if lengths is not None:
        for i, length in enumerate(np.asarray(lengths).reshape(-1)):
            out[i, int(length):] = 0.0
    return out[0] if squeeze else out
