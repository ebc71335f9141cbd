"""Single-source shortest paths (delta-free frontier Bellman-Ford).

Reference parity: gunrock::sssp (/root/reference/include/gunrock/algorithms/
sssp.hxx:110-151): per iteration, active sources relax out-edges with
atomicMin; the visited-iteration dedup filter (sssp.hxx:126-136) is
unnecessary here (boolmap frontiers cannot hold duplicates). The atomicMin
becomes a deterministic segment-MIN; predecessors break ties by smallest
source id via a second segment pass.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.frontier import frontier_from_indices
from essentials_tpu.framework.enactor import enact, default_converged, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import advance, Combine
from essentials_tpu.ops.sparse_advance import (
    spray_enabled, spray_k, SPRAY_BUDGET, TINY_BUDGET, TINY_K,
    frontier_out_degree, frontier_degree_sum, spray_relax_min,
    compact_frontier)


class SsspState(NamedTuple):
    """Hybrid frontier (see BfsState): boolmap + synced index list."""
    distances: jax.Array      # float32[Vp], +inf where unreached
    predecessors: jax.Array   # int32[Vp], -1 where none
    frontier: jax.Array       # bool[Vp]
    fidx: jax.Array           # int32[K]
    fcount: jax.Array         # int32
    fvalid: jax.Array         # bool


class SsspResult(NamedTuple):
    distances: jax.Array
    predecessors: jax.Array
    iterations: int
    elapsed_ms: float


def init(g: Graph, source) -> SsspState:
    vp = g.n_vertices_padded
    dist = jnp.full(vp, jnp.inf, jnp.float32).at[source].set(0.0)
    pred = jnp.full(vp, -1, jnp.int32)
    fidx = jnp.full(spray_k(g), g.pad_vertex, jnp.int32).at[0].set(source)
    return SsspState(dist, pred,
                     frontier_from_indices(g, jnp.asarray([source])),
                     fidx, jnp.int32(1), jnp.asarray(True))


def step(g: Graph, state: SsspState, it) -> SsspState:
    """One relaxation round. Work-adaptive like bfs.step (3-way lax.switch
    on the frontier's total out-degree): small frontiers relax exactly
    their out-edges via the budgeted spray path (degree-skew tolerant),
    large frontiers run the dense segment engine (two MIN passes: distance
    + smallest-id predecessor)."""
    dist, pred, frontier, fidx, fcount, fvalid = state
    K = spray_k(g)
    vp = g.n_vertices_padded
    imax = jnp.iinfo(jnp.int32).max

    def dense_relax(f):
        cand = advance(g, lambda e: e.src_vals[0] + e.weight, f,
                       src_values=(dist,), combine=Combine.MIN,
                       with_frontier=False)
        nd = jnp.minimum(cand, dist)

        # Deterministic predecessor: smallest source id achieving the new
        # distance at an improved destination.
        def pred_op(e):
            achieves = (e.src_vals[0] + e.weight) == e.dst_vals[0]
            return jnp.where(achieves, e.src, imax)

        cand_pred = advance(g, pred_op, f, src_values=(dist,),
                            dst_values=(nd,), combine=Combine.MIN,
                            with_frontier=False)
        return cand, cand_pred

    if not spray_enabled(g):
        cand, cand_pred = dense_relax(frontier)
        fi, fc, fv = fidx, jnp.int32(0), jnp.asarray(False)
    else:
        degsum = frontier_degree_sum(g, frontier)

        def spray_tier(budget, k):
            def go(_):
                offs, deg = frontier_out_degree(g, fidx[:k])
                cand, cand_pred, nidx, nc = spray_relax_min(
                    g, fidx[:k], offs, deg, dist, budget, k)
                if k < K:
                    nidx = jnp.concatenate(
                        [nidx, jnp.full(K - k, g.pad_vertex, jnp.int32)])
                return cand, cand_pred, nidx, nc
            return go

        def dense(_):
            cand, cand_pred = dense_relax(frontier)
            improved = cand < dist
            nf = improved & g.vertex_mask()
            fc = jnp.count_nonzero(nf)
            nidx = jax.lax.cond(
                fc <= K, lambda m: compact_frontier(m, K, g.pad_vertex),
                lambda m: jnp.full(K, g.pad_vertex, jnp.int32), nf)
            return cand, cand_pred, nidx, fc

        branch = jnp.where(
            fvalid & (degsum <= TINY_BUDGET) & (fcount <= TINY_K), 0,
            jnp.where(fvalid & (degsum <= SPRAY_BUDGET), 1, 2))
        cand, cand_pred, fi, fc = jax.lax.switch(
            branch, [spray_tier(TINY_BUDGET, TINY_K),
                     spray_tier(SPRAY_BUDGET, K), dense], None)
        fv = fc <= K

    improved = cand < dist
    new_dist = jnp.where(improved, cand, dist)
    new_pred = jnp.where(improved, cand_pred, pred)
    return SsspState(new_dist, new_pred, improved & g.vertex_mask(),
                     fi, fc, fv)


def run(g: Graph, source: int, *, max_iterations: int | None = None,
        warmup: bool = True) -> SsspResult:
    """Frontier Bellman-Ford from ``source`` (3-tier spray/dense rounds)."""
    max_it = max_iterations if max_iterations is not None else g.n_vertices + 1
    v = g.n_vertices
    res: EnactResult = enact(step, default_converged, g, init(g, source),
                             max_iterations=max_it, warmup=warmup)
    st: SsspState = res.state
    return SsspResult(st.distances[:v], st.predecessors[:v],
                      res.iterations, res.elapsed_ms)


def cpu_reference(csr, source: int) -> np.ndarray:
    """Host Dijkstra (reference parity:
    examples/algorithms/sssp/sssp_cpu.hxx — priority-queue Dijkstra)."""
    import heapq
    n = csr.n_rows
    offsets = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values, dtype=np.float64)
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for e in range(offsets[u], offsets[u + 1]):
            vtx, nd = cols[e], d + vals[e]
            if nd < dist[vtx]:
                dist[vtx] = nd
                heapq.heappush(heap, (nd, vtx))
    return dist.astype(np.float32)
