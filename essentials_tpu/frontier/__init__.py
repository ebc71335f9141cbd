"""Frontiers: dense boolean maps over vertices/edges (the choice static shapes favour).

The reference's primary frontier is a compacted sparse vector with invalid
sentinels (/root/reference/include/gunrock/framework/frontier/
vector_frontier.hxx) and its experimental `boolmap_frontier` is exactly the
dense representation XLA wants (boolmap_frontier.hxx — disabled there,
first-class here). Dedup (`uniquify`) is free, compaction never happens, and
emptiness/count are single reductions that can live *inside* jitted while
loops (no host round-trip, unlike the reference's per-iteration host check at
framework/enactor.hxx:294-296).

A fixed-capacity index-list view is provided for interop/printing and for
low-occupancy kernels that want gather lists.
"""

from essentials_tpu.frontier.boolmap import (
    empty_frontier, full_frontier, frontier_from_indices, frontier_size,
    frontier_is_empty, frontier_to_indices,
)

__all__ = [
    "empty_frontier", "full_frontier", "frontier_from_indices",
    "frontier_size", "frontier_is_empty", "frontier_to_indices",
]
