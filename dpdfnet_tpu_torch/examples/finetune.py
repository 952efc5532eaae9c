"""Fine-tuning example (counterpart of the repository's
``examples/finetune.py``): fits the model to a synthetic denoising task
with ``train.make_train_step`` and Adam, batch-split over every visible
card when there is more than one (``parallel.mesh.make_mesh``).  The
template for fine-tuning converted checkpoints on real (noisy, clean)
pairs.

    python -m dpdfnet_tpu_torch.examples.finetune [--model dpdfnet2] [--steps 10]
        [--batch 4] [--seconds 1.0] [--lr 1e-4] [--device cuda|cpu]

Prints the loss of each step.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dpdfnet2")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import train
    from ..config import get_config
    from ..models.params import init_params
    from ..parallel.mesh import make_mesh
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.model)
    mesh = make_mesh() if dev.type == "cuda" and torch.cuda.device_count() > 1 else None
    home = dev
    if mesh is not None:
        home = mesh.devices[0]
        print(f"[INFO] data-parallel over {mesh.size} devices")
    params = init_params(cfg, seed=0, device=home)   # or models.convert.load_params(ckpt)
    opt = torch.optim.Adam(train.trainable_parameters(params), lr=args.lr)
    step = train.make_train_step(cfg, opt, mesh=mesh)

    S = int(args.seconds * cfg.sample_rate)
    rng = np.random.default_rng(0)
    t = np.arange(S) / cfg.sample_rate
    clean = np.tile((0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), (args.batch, 1))
    clean_d = torch.from_numpy(clean).to(home)
    for i in range(args.steps):
        noisy = clean + 0.1 * rng.normal(size=clean.shape).astype(np.float32)
        loss, _ = step(params, torch.from_numpy(noisy).to(home), clean_d)
        print(f"step {i:3d}  loss {float(loss):.5f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
