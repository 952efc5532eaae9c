"""Set-up shared by the port's tests: one thread budget per process and one
cached copy of each reference weight tree.

Threads.  The tier-1 command runs six xdist workers on an eight-core CPU.
Each worker's numpy loads OpenBLAS, which starts one thread per core, so
48 or more BLAS threads spin on eight cores, and a one-call-per-weight
``np.linalg.svd`` (the JAX ``contract_params``) of ``dpdfnet8_48khz_hr``
took 95 s beside five other workers against 0.4 s with OpenBLAS held to
one thread; whole port test files ran three to eight times faster under
that limit.  Importing this module limits every BLAS library already
loaded (numpy's OpenBLAS: ``threadpoolctl`` reaches only loaded libraries,
hence the imports above the call) and torch's intra-op pool to one thread
each, and sets the same budget in the environment that the processes
tests start inherit (a CLI run, the exported artifact's consumer: with
torch's default of a thread per core beside five workers, the consumer
ran past its 600 s timeout).  Every xdist worker imports every test module
while it collects, so the limit holds in each worker from its first test,
the JAX package's tests included.  A port test module imports this module
and sets no thread count of its own.

Weights.  ``jax_params_np`` and ``port_params_np`` build each contracted
random tree once per process.  The trees are shared by every caller: a
caller that changes a tree's structure or leaves works on a copy
(``copy.deepcopy``).
"""

import dataclasses
import functools
import os

import numpy as np
import torch
from threadpoolctl import threadpool_limits

from dpdfnet_tpu_torch.config import get_config as port_get_config
from dpdfnet_tpu_torch.models import params as port_params
from dpdfnet_tpu_torch.utils.tree import tree_map

threadpool_limits(1, user_api="blas")
torch.set_num_threads(1)
os.environ.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")


@functools.lru_cache(maxsize=None)
def jax_params_np(name, seed=3, **overrides):
    """The JAX package's ``init_params`` + ``contract_params`` of config
    ``name`` (with ``overrides`` replaced in it) as a tree of numpy arrays.
    The reference weights that every parity test hands to both packages."""
    # imported here: modules that compare nothing with JAX import this
    # module for its thread budget alone
    import jax
    from dpdfnet_tpu.config import get_config
    from dpdfnet_tpu.models.params import contract_params, init_params

    cfg = dataclasses.replace(get_config(name), **overrides)
    return jax.tree_util.tree_map(np.asarray, contract_params(init_params(cfg, seed=seed)))


@functools.lru_cache(maxsize=None)
def port_params_np(name, seed=3):
    """The port's ``init_params`` + ``contract_params`` of config ``name``
    as a tree of numpy arrays (its tree and shapes are the JAX package's:
    ``test_torch_package.py``), for tests that need weights but no JAX
    reference to them."""
    p = port_params.contract_params(
        port_params.init_params(port_get_config(name), seed=seed, device="cpu"))
    return tree_map(lambda _, x: x.numpy(), p)
