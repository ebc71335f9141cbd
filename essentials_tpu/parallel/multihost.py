"""Multi-host orchestration.

The reference has no multi-node story at all (SURVEY §2.4). Here: thin
wrappers over jax.distributed so the same mesh/shard_map programs span
hosts — collectives are inserted by XLA from the same `shard_map` code
used single-host.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the multi-process runtime (no-op if single-process).

    Pass coordinator_address="host:port", num_processes and process_id
    explicitly (nothing auto-detects a cluster on a plain GPU host).
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis_name: str = "v"):
    """1-D mesh over every device across all processes."""
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis_name,))


def is_coordinator() -> bool:
    return jax.process_index() == 0


def to_global(mesh, spec, arr):
    """Place a host array (identical on every process) as a GLOBAL jax
    array sharded by ``spec`` over ``mesh``. Identity under a single
    process — multi-controller jit cannot accept plain host arrays for
    cross-process shardings, so the dist_* entry points route every
    input through this."""
    if jax.process_count() == 1:
        return arr
    import numpy as np
    from jax.sharding import NamedSharding
    np_arr = np.asarray(arr)
    return jax.make_array_from_callback(
        np_arr.shape, NamedSharding(mesh, spec),
        lambda idx: np_arr[idx])
