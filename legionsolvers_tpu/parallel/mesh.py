"""Device mesh construction and sharding helpers.

JAX replacement for the reference's mapper + sharding functor
(reference: LegionSolversMapper.cpp:91-98, 140-151).  The reference's
``BlockingShardingFunctor`` assigns contiguous blocks of the 1-D color space
to nodes; here the same policy is expressed once as a 1-D ``jax.sharding.Mesh``
over all devices with a single axis named :data:`~legionsolvers_tpu.options.SHARD_AXIS`,
and ``NamedSharding`` annotations — XLA's SPMD partitioner plays the role of
the mapper, placing each contiguous block on one device and inserting
collectives where needed.

Multi-host: one jax process per host + ``jax.distributed.initialize`` gives
control replication by construction (the analog of the reference's replicated
top-level tasks, Test05COOSolveCG.cpp:101-106); ``make_mesh`` then sees all
devices across hosts and lays the shard axis over them in order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..options import SHARD_AXIS


def make_mesh(
    num_shards: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build the 1-D solver mesh over ``num_shards`` devices.

    ``num_shards`` defaults to all available devices (the analog of the
    reference's "pieces = 4 x nodes" launch policy, bench_all.py:169-208,
    except that one piece per device is the natural choice here).
    """
    if devices is None:
        devices = jax.devices()
    if num_shards is None:
        num_shards = len(devices)
    if num_shards > len(devices):
        raise ValueError(
            f"requested {num_shards} shards but only {len(devices)} devices"
        )
    dev = np.asarray(devices[:num_shards])
    return Mesh(dev, (SHARD_AXIS,))


def single_device_mesh(device: Optional[jax.Device] = None) -> Mesh:
    """A 1-shard mesh (single-chip runs; everything still goes through the
    same sharded code paths with S=1)."""
    if device is None:
        device = jax.devices()[0]
    return Mesh(np.asarray([device]), (SHARD_AXIS,))


def sharded(mesh: Mesh) -> NamedSharding:
    """Sharding that block-partitions axis 0 over the shard axis."""
    return NamedSharding(mesh, P(SHARD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding (scalars, small dense workspaces)."""
    return NamedSharding(mesh, P())


def num_shards(mesh: Mesh) -> int:
    return mesh.shape[SHARD_AXIS]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host initialization (the analog of the reference's GASNet-EX
    bootstrap under ``Legion::Runtime::start``, build_legion.py:94-96 +
    jsrun launch, bench_all.py:44-67).  One jax process per host; after this,
    ``jax.devices()`` spans all hosts and ``make_mesh()`` lays the shard
    axis across them.  Arguments default to
    the standard cluster env vars (``JAX_COORDINATOR_ADDRESS`` etc.); no-op
    when already initialized or single-process."""
    import jax.distributed

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already initialized" not in str(e):
            raise
