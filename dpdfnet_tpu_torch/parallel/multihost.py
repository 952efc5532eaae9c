"""Multi-host scale-out (counterpart of ``dpdfnet_tpu.parallel.multihost``).

Utterances are independent, so several hosts (or several processes on one
machine) need no collectives on the audio path: each runs the same
single-host program (the batch split over its local GPUs,
``parallel.mesh``) on a disjoint slice of the file list.  The process
group carries only control traffic.

- :func:`initialize`: ``torch.distributed.init_process_group`` (NCCL on a
  card, gloo on the CPU) with the defaults ``torchrun`` exports, once.
- :func:`shard_files_for_host`: host ``h`` of ``n`` takes ``files[h::n]``
  of the size-sorted list, a disjoint cover that balances the audio per
  host and keeps each shard size-sorted.
- :func:`local_mesh`: the mesh over this process's GPUs.

Run the same command in every process, e.g. two processes on one machine:

    torchrun --nproc-per-node 2 -m dpdfnet_tpu_torch enhance-dir IN OUT --distributed

or, without a process group (independent jobs over a shared file system),
``--num-hosts N --host-id K`` in each; the file shards are the same.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional, Sequence, TypeVar

T = TypeVar("T")

_INITIALIZED = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the process group (idempotent; a group someone else made is
    kept).  Arguments default to ``torchrun``'s environment:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  The
    coordinator is ``host:port`` (or a ``tcp://`` URL).  NCCL when a GPU is
    visible, else gloo; with several processes per machine each takes the
    GPU of its ``LOCAL_RANK`` as its current device."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        _INITIALIZED = True
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of processes and this "
            "process's id, as arguments or as MASTER_ADDR / MASTER_PORT, WORLD_SIZE and "
            f"RANK (got {coordinator_address!r}, {num_processes!r}, {process_id!r})")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    gpu = torch.cuda.is_available()
    if gpu and "LOCAL_RANK" in env:
        torch.cuda.set_device(int(env["LOCAL_RANK"]) % torch.cuda.device_count())
    dist.init_process_group("nccl" if gpu else "gloo", init_method=url,
                            world_size=int(num_processes), rank=int(process_id))
    atexit.register(lambda: dist.is_initialized() and dist.destroy_process_group())
    _INITIALIZED = True


def host_info(host_id: Optional[int] = None, num_hosts: Optional[int] = None) -> tuple:
    """Resolve ``(host_id, num_hosts)``: explicit arguments, then
    ``DPDFNET_TPU_HOST_ID`` / ``DPDFNET_TPU_NUM_HOSTS``, then the process
    group's rank and world size (``(0, 1)`` without one).  Inconsistent
    values raise, so a bad launch fails instead of processing files
    twice."""
    env_id = os.environ.get("DPDFNET_TPU_HOST_ID")
    env_n = os.environ.get("DPDFNET_TPU_NUM_HOSTS")
    if num_hosts is None:
        num_hosts = int(env_n) if env_n is not None else None
    if host_id is None:
        host_id = int(env_id) if env_id is not None else None
    if num_hosts is None and host_id is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    if num_hosts is None or host_id is None:
        raise ValueError(
            "host_id and num_hosts must be given together "
            f"(got host_id={host_id}, num_hosts={num_hosts})")
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} out of range for num_hosts {num_hosts}")
    return host_id, num_hosts


def shard_files_for_host(files: Sequence[T], host_id: Optional[int] = None,
                         num_hosts: Optional[int] = None) -> list:
    """This host's slice of ``files``, ``files[h::n]``: a deterministic
    disjoint cover when every host lists the files in the same order (the
    size-sorted listing of ``enhance-dir``)."""
    host_id, num_hosts = host_info(host_id, num_hosts)
    if num_hosts <= 1:
        return list(files)
    return list(files[host_id::num_hosts])


def local_mesh():
    """The mesh over this process's GPUs: every visible GPU, or with
    several processes per machine (``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``)
    the GPUs ``LOCAL_RANK``, ``LOCAL_RANK + LOCAL_WORLD_SIZE``, ...  (one
    each when the counts match).  Raises without a GPU, as ``make_mesh``
    does."""
    import torch

    from ..utils.device import resolve_device
    from .mesh import make_mesh

    resolve_device(None)
    count = torch.cuda.device_count()
    rank = int(os.environ.get("LOCAL_RANK", 0))
    procs = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    mine = list(range(count))[rank::procs] if procs > 1 else list(range(count))
    return make_mesh([f"cuda:{i}" for i in (mine or [rank % count])])
