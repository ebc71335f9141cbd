"""Sparse-frontier advance: O(|frontier| * max_degree) supersteps.

The dense segment engine (ops/advance.py) does O(E) work per superstep —
ideal for expansion-heavy phases, catastrophic for high-diameter graphs
(road networks: thousands of supersteps with frontiers of a few thousand
vertices). This operator is the analogue of the reference's
frontier-proportional work model (vector frontiers,
framework/frontier/vector_frontier.hxx): it compacts the boolmap frontier
into a CAPPED index list (`jnp.nonzero(..., size=K)` — static shapes!) and
relaxes the K*dmax candidate edges with XLA gathers/scatters.

It wins when K*dmax is small — exactly the regime where the dense engine
wastes the whole edge axis. Algorithms switch per-superstep with `lax.cond` on
the frontier population (see bfs.step_adaptive / sssp.step_adaptive);
both branches live in the same compiled while_loop, the pick is on-device.

Reference parity note: this plays the role of the reference's
frontier_view_t::vector mode + thread-mapped advance
(advance/thread_mapped.hxx) for small frontiers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from essentials_tpu.graph.graph import Graph

# the candidate matrix enumerates at most this many edges per frontier
# vertex; a SPECIFIC frontier takes the sparse path only when all its
# members' degrees fit (checked on-device: frontier_idx_ok) — so skewed
# graphs still get sparse supersteps for their low-degree tail frontiers
DMAX_CAP = 64
DEFAULT_K = 4096
# candidate-matrix budget: XLA scatters/gathers visit every [K, dcap] slot
# whether masked or not, so the sparse step costs O(BUDGET) plus a fixed
# floor regardless of how full the frontier is; K is sized so that stays
# well under a dense superstep
_BUDGET = 1 << 15
# ... and the graph must be big enough that a dense superstep costs more
# than the sparse path's fixed floor (a few million edges; the crossover
# has not been measured on a GPU — ROADMAP speed item 5)
_MIN_EDGES = 1 << 21


def sparse_enabled(g: Graph, k: int | None = None) -> bool:
    """Static (trace-time) gate for compiling the sparse branch.

    Low-degree graphs only: on skewed graphs the candidate budget rarely
    fits a tail frontier, so the per-round checks and carried index state
    do not pay for themselves. kcore's empty-round skip is separate and
    stays on for every graph."""
    return 0 < g.max_degree <= DMAX_CAP and g.n_edges > _MIN_EDGES


def dcap(g: Graph) -> int:
    return min(g.max_degree, DMAX_CAP)


def k_for(g: Graph) -> int:
    """Frontier index-list capacity: fills the candidate budget."""
    return max(512, min(DEFAULT_K, _BUDGET // dcap(g)))


def frontier_idx_ok(g: Graph, idx: jax.Array, count) -> jax.Array:
    """On-device check that ``idx`` is a usable sparse frontier: fits the
    cap AND every member's out-degree fits the candidate matrix."""
    deg = g.row_offsets[idx + 1] - g.row_offsets[idx]
    deg = jnp.where(idx == g.pad_vertex, 0, deg)
    return (count <= idx.shape[0]) & (jnp.max(deg) <= dcap(g))


def compact_frontier(frontier: jax.Array, k: int, fill: int) -> jax.Array:
    """First <=k set indices (ascending), ``fill`` beyond. Sort-based (one
    lax.sort over the vertex axis)."""
    vp = frontier.shape[0]
    key = jnp.where(frontier, jnp.arange(vp, dtype=jnp.int32),
                    jnp.int32(2**30))
    s = jax.lax.sort(key)[:k]
    if s.shape[0] < k:               # tiny graph: Vp < K
        s = jnp.pad(s, (0, k - s.shape[0]), constant_values=2**30)
    return jnp.where(s < 2**30, s, fill)


def _neighborhoods(g: Graph, frontier: jax.Array, k: int):
    """Compact the frontier to <=k indices and enumerate candidate edges.

    Returns (idx [k], e [k,dmax], nb [k,dmax], valid [k,dmax]); overflow
    beyond k is the caller's responsibility (gate with count <= k).
    """
    dmax = dcap(g)
    idx = compact_frontier(frontier, k, g.pad_vertex)
    offs = g.row_offsets[idx]
    deg = g.row_offsets[idx + 1] - offs
    active = idx != g.pad_vertex
    j = jnp.arange(dmax, dtype=offs.dtype)
    valid = (j[None, :] < deg[:, None]) & active[:, None]
    e = jnp.where(valid, offs[:, None] + j[None, :], 0)
    nb = g.col_indices[e]
    return idx, e, nb, valid


def _neighborhoods_idx(g: Graph, idx: jax.Array):
    """Candidate edges for an index-list frontier (pad slots = pad_vertex)."""
    dmax = dcap(g)
    offs = g.row_offsets[idx]
    deg = g.row_offsets[idx + 1] - offs
    active = idx != g.pad_vertex
    j = jnp.arange(dmax, dtype=offs.dtype)
    valid = (j[None, :] < deg[:, None]) & active[:, None]
    e = jnp.where(valid, offs[:, None] + j[None, :], 0)
    nb = g.col_indices[e]
    return e, nb, valid


def next_frontier_idx(nb: jax.Array, keep: jax.Array, k: int, fill: int):
    """Compact the kept candidates [k, dmax] into a deduplicated ascending
    index list [k] (+ distinct count). Two small sorts — O(k*dmax), never
    O(V)."""
    big = jnp.int32(2**30)
    flat = jnp.where(keep, nb.astype(jnp.int32), big).reshape(-1)
    s1 = jax.lax.sort(flat)
    dup = jnp.concatenate([jnp.zeros(1, jnp.bool_), s1[1:] == s1[:-1]])
    s2 = jax.lax.sort(jnp.where(dup, big, s1))
    count = jnp.sum(s2 < big)
    idx = jnp.where(s2[:k] < big, s2[:k], fill)
    return idx, count


# --------------------------------------------------------------------- #
# Spray path (v2): sum-of-degrees budgeted, degree-skew tolerant.
#
# The candidate-matrix path above pays O(K * dcap) slots with a STATIC
# degree cap — useless on power-law graphs where one hub blows the cap.
# The spray path enumerates exactly the frontier's out-edges (ragged ->
# static slots via scatter+cumsum over the budget axis) so the only gate is
# sum(deg(frontier)) <= budget, checked on device per superstep.
#
# Budget 32768 keeps every gather/scatter/sort of a spray superstep small
# next to a dense O(E) superstep (the budgets have not been re-derived on a
# GPU — ROADMAP speed item 5).
#
# Reference parity: this is the replacement for thread-mapped advance
# over vector frontiers (advance/thread_mapped.hxx) — work proportional to
# the frontier's out-degree, not to E and not to K*max_degree.

SPRAY_BUDGET = 1 << 15        # candidate edge slots
SPRAY_K = 1 << 14             # index-list capacity
# tiny tier: near-empty frontiers (head/tail BFS levels) pay ~5x less for
# the fixed gather/sort costs that scale with the budget, not the frontier
TINY_BUDGET = 1 << 12
TINY_K = 1 << 11


def frontier_degree_sum(g: Graph, frontier: jax.Array) -> jax.Array:
    """Total out-degree of a boolmap frontier — the spray-budget gate,
    computed WITHOUT the index list (one [Vp] elementwise + reduce; the
    per-index gathers happen only inside the spray branch)."""
    deg = g.row_offsets[1:] - g.row_offsets[:-1]
    return jnp.sum(jnp.where(frontier, deg, 0).astype(jnp.int32))


def spray_enabled(g: Graph) -> bool:
    """Static gate: the graph must be big enough that a dense superstep
    costs more than the spray path's fixed floor."""
    return g.n_edges > _MIN_EDGES


def spray_k(g: Graph) -> int:
    return SPRAY_K


def frontier_out_degree(g: Graph, idx: jax.Array):
    """(offs [K], deg [K]) of an index-list frontier (pad slots -> 0)."""
    offs = g.row_offsets[idx]
    deg = jnp.where(idx == g.pad_vertex, 0, g.row_offsets[idx + 1] - offs)
    return offs, deg.astype(jnp.int32)


def spray_candidates(g: Graph, idx: jax.Array, offs: jax.Array,
                     deg: jax.Array, budget: int, *,
                     with_src: bool = False):
    """Enumerate ALL out-edges of the frontier into `budget` static slots.

    Requires sum(deg) <= budget (gate with the on-device check before
    lax.cond-ing into this branch). Returns (e [B] edge ids, nb [B] dst,
    src [B] source ids or None, valid [B]).

    Gather-free expansion: within frontier member i's slot range, the edge
    id is e = j + (offs[i] - pfx[i]) — a per-segment constant. Expanding a
    per-segment constant needs no gather: scatter its K-axis DIFFS at the
    segment-start slots and cumsum over the budget axis (the telescoping
    trick of ops/segment.py at sparse scale)."""
    pfx = jnp.cumsum(deg) - deg                        # exclusive prefix
    total = pfx[-1] + deg[-1]
    j = jnp.arange(budget, dtype=jnp.int32)
    valid = j < total

    def expand_const(per_seg):
        d = jnp.diff(per_seg, prepend=jnp.zeros(1, per_seg.dtype))
        z = jnp.zeros(budget, per_seg.dtype).at[pfx].add(d, mode="drop")
        return jnp.cumsum(z)

    e = jnp.where(valid, j + expand_const(offs - pfx), 0)
    nb = g.col_indices[e]
    src = expand_const(idx) if with_src else None
    return e, nb, src, valid


def spray_dedup(nb: jax.Array, keep: jax.Array, k: int, fill: int):
    """Distinct kept candidates: (sorted_all [B] with 2^30 sentinels &
    duplicates pushed last, idx [k] first-k distinct, count)."""
    big = jnp.int32(2 ** 30)
    s1 = jax.lax.sort(jnp.where(keep, nb.astype(jnp.int32), big))
    dup = jnp.concatenate([jnp.zeros(1, jnp.bool_), s1[1:] == s1[:-1]])
    s2 = jax.lax.sort(jnp.where(dup, big, s1))
    count = jnp.sum(s2 < big)
    idx = jnp.where(s2[:k] < big, s2[:k], fill)
    return s2, idx, count


def spray_reach(g: Graph, idx: jax.Array, offs: jax.Array, deg: jax.Array,
                unvisited: jax.Array, budget: int, k: int):
    """BFS-style reach over the sprayed out-edges.

    Returns (newly bool[Vp] — unvisited vertices with an in-edge from the
    frontier, nidx [k] — first-k distinct such vertices, ncount)."""
    _, nb, _, valid = spray_candidates(g, idx, offs, deg, budget)
    fresh = valid & unvisited[nb]
    uniq, nidx, ncount = spray_dedup(nb, fresh, k, g.pad_vertex)
    newly = jnp.zeros(g.n_vertices_padded, jnp.bool_).at[uniq].set(
        True, mode="drop")
    return newly, nidx, ncount


def spray_relax_min(g: Graph, idx: jax.Array, offs: jax.Array,
                    deg: jax.Array, dist: jax.Array, budget: int, k: int):
    """SSSP relaxation over the sprayed out-edges (budget-gated, no degree
    cap). Returns (cand f32[Vp] — MIN over frontier in-edges of
    dist[src]+w, +inf elsewhere; pred int32[Vp] — smallest source id
    achieving cand; nidx int32[k] — first-k distinct improved dsts;
    ncount). Deterministic tie-breaks match the dense engine."""
    e, nb, _, valid = spray_candidates(g, idx, offs, deg, budget)
    # dist[src] per candidate: per-segment-constant expansion of the
    # frontier's distances (bitcast telescoping — exact for f32)
    pfx = jnp.cumsum(deg) - deg
    src_d = jnp.where(idx == g.pad_vertex, 0.0, dist[idx])
    di = jax.lax.bitcast_convert_type(src_d, jnp.int32)
    dd = jnp.diff(di, prepend=jnp.zeros(1, jnp.int32))
    z = jnp.zeros(budget, jnp.int32).at[pfx].add(dd, mode="drop")
    d_e = jax.lax.bitcast_convert_type(jnp.cumsum(z), jnp.float32)
    cand_e = jnp.where(valid, d_e + g.values[e], jnp.inf)
    vp = g.n_vertices_padded
    cand = jnp.full(vp, jnp.inf, dist.dtype).at[nb].min(cand_e, mode="drop")
    achieves = valid & (cand_e == cand[nb])
    imax = jnp.iinfo(jnp.int32).max
    src_seg = jnp.where(idx == g.pad_vertex, 0, idx)
    ds = jnp.diff(src_seg, prepend=jnp.zeros(1, jnp.int32))
    zs = jnp.zeros(budget, jnp.int32).at[pfx].add(ds, mode="drop")
    src_e = jnp.cumsum(zs)
    pred = jnp.full(vp, imax, jnp.int32).at[nb].min(
        jnp.where(achieves, src_e, imax), mode="drop")
    improved_nb = valid & (cand_e <= cand[nb]) & (cand[nb] < dist[nb])
    _, nidx, ncount = spray_dedup(nb, improved_nb, k, g.pad_vertex)
    return cand, pred, nidx, ncount


def sparse_reach(g: Graph, frontier: jax.Array, k: int = DEFAULT_K
                 ) -> jax.Array:
    """bool[Vp]: vertices with an in-edge from the frontier (BFS reach)."""
    _, _, nb, valid = _neighborhoods(g, frontier, k)
    out = jnp.zeros(g.n_vertices_padded, jnp.int8)
    out = out.at[nb].max(valid.astype(jnp.int8), mode="drop")
    return out > 0


def sparse_relax_min(g: Graph, frontier: jax.Array, dist: jax.Array,
                     k: int = DEFAULT_K):
    """SSSP relaxation over the compacted frontier.

    Returns (cand float32[Vp] — MIN over frontier in-edges of
    dist[src]+w, +inf elsewhere; pred int32[Vp] — smallest source id
    achieving cand, int32max elsewhere). Matches the dense advance's
    deterministic tie-break.
    """
    idx, e, nb, valid = _neighborhoods(g, frontier, k)
    src_d = dist[idx]
    cand_e = jnp.where(valid, src_d[:, None] + g.values[e], jnp.inf)
    vp = g.n_vertices_padded
    cand = jnp.full(vp, jnp.inf, dist.dtype).at[nb].min(cand_e, mode="drop")
    achieves = valid & (cand_e == cand[nb])
    src_ids = jnp.broadcast_to(idx[:, None], nb.shape)
    imax = jnp.iinfo(jnp.int32).max
    pred = jnp.full(vp, imax, jnp.int32).at[nb].min(
        jnp.where(achieves, src_ids.astype(jnp.int32), imax), mode="drop")
    return cand, pred
