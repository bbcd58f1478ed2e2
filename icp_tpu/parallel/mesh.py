"""Device-mesh helpers for the sharded engine.

The reference has no multi-device code of any kind (SURVEY.md §2 parallelism
table); this module is the foundation the reference lacks: a 1-D ``points``
mesh over all devices, used to shard scene/model points.  The mesh follows
the algorithm: the cards of one host reach each other all to all (NVLink),
so no device order is preferred.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

POINTS_AXIS = "points"


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None, axis: str = POINTS_AXIS
) -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up: one call per host before any mesh construction.

    Thin wrapper over ``jax.distributed.initialize``; pass the coordinator
    address (``host:port``), the process count and this process's id —
    nothing detects a cluster on its own.  After this, ``make_mesh()`` spans
    every device of every process and the sharded engine's collectives run
    over NCCL — the distributed backend the reference lacks entirely
    (SURVEY.md §5).
    """
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def points_sharding(mesh: Mesh, axis: str = POINTS_AXIS) -> NamedSharding:
    """Rows (points) sharded, coordinates replicated."""
    return NamedSharding(mesh, PartitionSpec(axis, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
