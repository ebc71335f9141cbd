"""Breadth-first search.

Reference parity: gunrock::bfs (/root/reference/include/gunrock/algorithms/
bfs.hxx:110-178): frontier-driven level-synchronous BFS. The hot loop
computes ONLY the reached-set per level (an OR-combine over the edge
axis); depths are assigned from
the iteration counter; predecessors are derived afterwards in a single
full-graph advance (MIN over sources one level up) instead of the
reference's per-step atomic races — deterministic smallest-id predecessors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.frontier import frontier_from_indices
from essentials_tpu.framework.enactor import enact, default_converged
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, advance_count, Combine, AdvanceIO
from essentials_tpu.ops.sparse_advance import (
    spray_enabled, spray_k, SPRAY_BUDGET, TINY_BUDGET, TINY_K,
    frontier_out_degree, frontier_degree_sum, spray_reach, compact_frontier)

UNREACHED = np.iinfo(np.int32).max


class BfsState(NamedTuple):
    """Hybrid frontier: the boolmap is always maintained; when the index
    list is current (fvalid) AND the frontier's total out-degree fits the
    spray budget, the level runs the O(sum deg) spray path instead of the
    dense O(E) segment engine. Skew-tolerant: the gate is sum-of-degrees,
    so hub vertices are fine as long as the level's edge work is small."""
    distances: jax.Array      # int32[Vp], UNREACHED where not found yet
    frontier: jax.Array       # bool[Vp]
    fidx: jax.Array           # int32[K] frontier indices (pad_vertex-filled)
    fcount: jax.Array         # int32: |frontier|
    fvalid: jax.Array         # bool: fidx is in sync with frontier


class BfsResult(NamedTuple):
    distances: jax.Array
    predecessors: jax.Array
    iterations: int
    elapsed_ms: float


def init(g: Graph, source: int | jax.Array) -> BfsState:
    vp = g.n_vertices_padded
    dist = jnp.full(vp, UNREACHED, jnp.int32).at[source].set(0)
    frontier = frontier_from_indices(g, jnp.asarray([source]))
    fidx = jnp.full(spray_k(g), g.pad_vertex, jnp.int32).at[0].set(source)
    return BfsState(dist, frontier, fidx, jnp.int32(1), jnp.asarray(True))


def step(g: Graph, state: BfsState, it) -> BfsState:
    """One level. Work-adaptive 3-way lax.switch on the frontier's total
    out-degree (computed from the boolmap — one cheap [Vp] reduce, no
    per-index gathers outside the taken branch):

      tiny spray   sum(deg) <= 4K     head/tail levels
      spray        sum(deg) <= 32K    transition levels
      dense        otherwise          O(E) segment-engine advance

    The dense branch also compacts the next index list when it fits, so
    every graph drops back to spray for its small levels."""
    dist, frontier, fidx, fcount, fvalid = state
    K = spray_k(g)
    vp = g.n_vertices_padded

    def dense_reach(f):
        return advance_count(g, f) > 0

    if not spray_enabled(g):
        newly = dense_reach(frontier) & (dist == UNREACHED)
        return BfsState(jnp.where(newly, it + 1, dist), newly, fidx,
                        jnp.int32(0), jnp.asarray(False))

    degsum = frontier_degree_sum(g, frontier)

    def spray_tier(budget, k):
        def go(_):
            offs, deg = frontier_out_degree(g, fidx[:k])
            newly, nidx, nc = spray_reach(g, fidx[:k], offs, deg,
                                          dist == UNREACHED, budget, k)
            if k < K:
                nidx = jnp.concatenate(
                    [nidx, jnp.full(K - k, g.pad_vertex, jnp.int32)])
            return newly, nidx, nc
        return go

    def dense(_):
        newly = dense_reach(frontier) & (dist == UNREACHED)
        fc = jnp.count_nonzero(newly)
        # compact only when the next frontier fits (transition rounds);
        # big-frontier rounds skip the O(V) sort
        nidx = jax.lax.cond(
            fc <= K, lambda m: compact_frontier(m, K, g.pad_vertex),
            lambda m: jnp.full(K, g.pad_vertex, jnp.int32), newly)
        return newly, nidx, fc

    branch = jnp.where(
        fvalid & (degsum <= TINY_BUDGET) & (fcount <= TINY_K), 0,
        jnp.where(fvalid & (degsum <= SPRAY_BUDGET), 1, 2))
    newly, fi, fc = jax.lax.switch(
        branch, [spray_tier(TINY_BUDGET, TINY_K),
                 spray_tier(SPRAY_BUDGET, K), dense], None)
    return BfsState(jnp.where(newly, it + 1, dist), newly, fi, fc, fc <= K)


def predecessors_from_distances(g: Graph, dist: jax.Array) -> jax.Array:
    """pred[v] = smallest-id in-neighbor one BFS level up (-1 at source /
    unreached). One full-graph advance (MIN)."""
    def msg(e):
        ok = (e.src_vals[0] + 1) == e.dst_vals[0]
        return jnp.where(ok, e.src, jnp.iinfo(jnp.int32).max)

    cand = advance(g, msg, None, src_values=(dist,), dst_values=(dist,),
                   input_kind=AdvanceIO.GRAPH, combine=Combine.MIN,
                   with_frontier=False)
    valid = (dist != UNREACHED) & (dist > 0) & (cand < jnp.iinfo(jnp.int32).max)
    return jnp.where(valid, cand, -1)


def run(g: Graph, source: int, *, max_iterations: int | None = None,
        compute_predecessors: bool = True, warmup: bool = True) -> BfsResult:
    """Level-synchronous BFS from ``source`` (3-tier spray/dense levels)."""
    max_it = max_iterations if max_iterations is not None else g.n_vertices + 1
    res = enact(step, default_converged, g, init(g, source),
                max_iterations=max_it, warmup=warmup)
    distances = res.state.distances
    v = g.n_vertices
    if compute_predecessors:
        pred = predecessors_from_distances(g, distances)[:v]
    else:
        pred = jnp.full(v, -1, jnp.int32)
    return BfsResult(distances[:v], pred, res.iterations, res.elapsed_ms)


def cpu_reference(csr, source: int) -> np.ndarray:
    """Host BFS (reference parity: examples/algorithms/bfs/bfs_cpu.hxx)."""
    n = csr.n_rows
    dist = np.full(n, UNREACHED, np.int32)
    dist[source] = 0
    frontier = [source]
    level = 0
    offsets, cols = np.asarray(csr.row_offsets), np.asarray(csr.col_indices)
    while frontier:
        level += 1
        nxt = []
        for u in frontier:
            for e in range(offsets[u], offsets[u + 1]):
                vtx = cols[e]
                if dist[vtx] == UNREACHED:
                    dist[vtx] = level
                    nxt.append(vtx)
        frontier = nxt
    return dist
