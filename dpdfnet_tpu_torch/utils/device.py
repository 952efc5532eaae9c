"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Without a
GPU and without an explicit CPU request they raise: the port never carries
on on the CPU behind the caller's back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request with no GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dpdfnet_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path.")
    return dev
