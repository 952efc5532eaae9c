"""Device mesh and batch sharding (counterpart of ``dpdfnet_tpu.parallel.mesh``).

Utterances and streams are independent, so the multi-device path is batch
data-parallelism: the JAX package ``shard_map``s one compiled program over
the utterance axis of a 1-D mesh, with the parameters replicated and no
collectives.  Here a mesh is an ordered tuple of torch devices, and an
engine on a mesh holds one replica engine per entry (its weights on that
device, its own CUDA graphs, graph pool, capture stream, state slots and
lock; ``runtime.engine.Engine(mesh=)``).  A batch is cut into consecutive
equal shards, one per entry, each shard runs the single-device path of its
replica, and the results are gathered in order.

A device may appear more than once: ``make_mesh(["cpu"] * 8)`` is the CPU
tests' mesh (torch has one CPU device where the JAX tests have eight
virtual ones), and ``make_mesh(["cuda:0", "cuda:0"])`` runs the split,
the pad and the gather on one card.

The JAX module's placements (``batch_sharding``, ``replicated``: its
``NamedSharding``s) have no torch caller: :func:`shard_batch` cuts a tree
itself, and each replica engine copies the weights to its own device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map

BATCH_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh of devices over the batch axis."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


class Sharded(tuple):
    """The per-device form of a tree whose leaves lead with the batch axis:
    one tree per mesh device, in mesh order, each holding its consecutive
    rows of the batch on its device (the form a mesh engine takes and
    returns for stream states)."""


def _index(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` means the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh over ``devices`` (every visible CUDA device by default; without
    a GPU that raises, as ``resolve_device`` does: pass ``["cpu"] * n`` for
    the CPU).  Entries may repeat."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_index(resolve_device(d)) for d in devices)
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devs)


def _leaf(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def shard_batch(mesh: Mesh, tree):
    """Place a tree whose leaves (tensors or arrays) lead with the batch
    axis onto the mesh: its :class:`Sharded` form, ``mesh.size``
    consecutive equal shards, shard i on device i; on a mesh of one device
    the tree itself on that device (what a single-device engine takes).
    A batch that the mesh size does not divide raises."""
    n = mesh.size

    def shard(i, d):
        def cut(path, x):
            x = _leaf(x)
            if x.shape[0] % n:
                raise ValueError(f"{path or 'leaf'}: batch {x.shape[0]} is not a multiple "
                                 f"of the mesh size ({n})")
            b = x.shape[0] // n
            return x[i * b:(i + 1) * b].to(d).contiguous()
        return tree_map(cut, tree)

    parts = Sharded(shard(i, d) for i, d in enumerate(mesh.devices))
    return parts[0] if n == 1 else parts


def gather(tree) -> np.ndarray:
    """A batch as one host array: a :class:`Sharded` batch's shards
    concatenated in mesh order, a tensor copied to the host, anything
    else through ``np.asarray``."""
    if isinstance(tree, Sharded):
        return np.concatenate([gather(part) for part in tree], axis=0)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def sharded_engine(cfg: ModelConfig, params, mesh: Mesh, **kwargs):
    """The production multi-device path: ``runtime.engine.Engine`` with its
    batch axis split over ``mesh`` (the same per-device code as one
    engine)."""
    from ..runtime.engine import Engine

    return Engine(cfg, params, mesh=mesh, **kwargs)


def make_sharded_enhance(cfg: ModelConfig, mesh: Mesh, *, precision: str = "high", **kwargs):
    """``fn(params, wav [B, S]) -> enhanced [B, S]`` (numpy) through
    :func:`sharded_engine`.  ``wav`` may be numpy, a tensor or a
    :class:`Sharded` batch.  The engine is cached by the params object and
    the entry holds a strong reference to it: the ``id`` of a freed tree
    can be reused, which would serve an engine built from earlier
    weights."""
    cache: dict = {}

    def fn(params, wav):
        key = id(params)
        hit = cache.get(key)
        if hit is None or hit[0] is not params:
            cache.clear()
            cache[key] = (params, sharded_engine(cfg, params, mesh, precision=precision,
                                                 **kwargs))
        return cache[key][1].enhance_waveforms(gather(wav))

    return fn


def make_sharded_stream_step(cfg: ModelConfig, mesh: Mesh, *, precision: str = "high",
                             **kwargs):
    """``fn(params, spec [B, T, F, 2], state) -> (out, state)``: the engine's
    streaming step over spec frames (``Engine._stream_spec_fn``), many
    independent streams split over the mesh, the state kept on the
    devices between calls (its :class:`Sharded` form, :func:`shard_batch`).
    ``out`` is gathered on the mesh's first device.  Engines are cached by
    the params object as in :func:`make_sharded_enhance`."""
    from ..runtime.engine import Engine

    cache: dict = {}

    def fn(params, spec, st):
        key = id(params)
        hit = cache.get(key)
        if hit is None or hit[0] is not params:
            cache.clear()
            cache[key] = (params, Engine(cfg, params, mesh=mesh, precision=precision,
                                         **kwargs))
        eng = cache[key][1]
        spec = _leaf(spec)
        return eng._stream_spec_fn(spec.shape[0], spec.shape[1])(spec, st)

    return fn
