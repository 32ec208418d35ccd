"""Device mesh construction and multi-host init.

The reference's distribution layer is single-process multi-GPU NCCL threads
(`src/caffe/parallel.cpp:327-362` NCCL::Run, one worker thread per GPU).
Replacement: a `jax.sharding.Mesh` over all addressable devices;
parallelism is expressed as shardings + collectives compiled by XLA (NCCL
over NVLink between GPUs), not as explicit communicator calls. The cards
of a host are joined all to all, so the mesh shape follows the algorithm.

Axes convention: ``data`` (batch / DP), ``model`` (output-channel TP or
spatial partitioning). One-axis meshes fold the other to size 1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """data=-1: use all remaining devices on the data axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data == -1:
        assert n % model == 0, (n, model)
        data = n // model
    assert data * model == n, (data, model, n)
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None):
    """Multi-host rendezvous (replaces the reference's out-of-band NCCL uid
    handshake, `parallel.cpp:125-137`). No-op if already initialized or
    single-process."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
