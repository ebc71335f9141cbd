"""Graph coloring (Jones-Plassmann independent sets, multi-wave).

Reference parity: gunrock::color (/root/reference/include/gunrock/algorithms/
color.hxx:63-141): random vertex priorities; per iteration each uncolored
vertex that is the max (resp. min) priority among its uncolored neighbors
takes color 2*it (resp. 2*it+1). The frontier is the uncolored vertex set.

Upgrades over the reference:

* m WAVES per sweep: m independent random priority permutations are
  evaluated against ONE expansion of the uncolored mask — round count
  divides by ~m (measured exactly m-fold on rmat graphs) while the per-round
  cost grows only by the per-wave combine, because the per-edge priorities
  are STATIC (expanded + permuted once at init).
* budget spray path for the shrinking uncolored tail (degree-skew
  tolerant: gate is sum-of-degrees, not max degree).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.frontier import full_frontier
from essentials_tpu.framework.enactor import enact, default_converged, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops import Combine
from essentials_tpu.ops.sparse_advance import (
    spray_enabled, compact_frontier, frontier_out_degree, spray_candidates,
    SPRAY_BUDGET, SPRAY_K)

# independent priority waves per sweep (round count divides by ~WAVES;
# each extra wave costs one MAX and one MIN combine)
WAVES = 8
IMAX = np.iinfo(np.int32).max


class ColorState(NamedTuple):
    """The uncolored set only SHRINKS, so once it fits the index list the
    sparse path keeps it current by filtering (no O(V) recompaction)."""
    colors: jax.Array       # int32[Vp], -1 = uncolored
    pris: jax.Array         # int32[WAVES, Vp] random priority permutations
    pri_csc: tuple          # WAVES x int32[Ep]: pris[j][src(e)], CSC order
    frontier: jax.Array     # bool[Vp] uncolored vertices
    fidx: jax.Array         # int32[K]
    fcount: jax.Array       # int32
    fvalid: jax.Array       # bool


class ColorResult(NamedTuple):
    colors: jax.Array
    iterations: int
    elapsed_ms: float


def _expand_pris_to_csc(g: Graph, pris):
    """Static per-edge priorities pris[j][src(e)] in CSC order."""
    from essentials_tpu.ops.segment import (expand_vertex_to_edges,
                                            apply_permutation)
    ep = g.n_edges_padded
    vals = tuple(pris[j] for j in range(pris.shape[0]))
    out = []
    for v in vals:
        e = expand_vertex_to_edges(v, g.row_offsets, ep)
        out.append(apply_permutation(g.csc_rank, e))
    return tuple(out)


def init(g: Graph, seed: int = 0) -> ColorState:
    vp = g.n_vertices_padded
    keys = jax.random.split(jax.random.PRNGKey(seed), WAVES)
    pris = jnp.stack([jax.random.permutation(k, vp).astype(jnp.int32)
                      for k in keys])
    pri_csc = _expand_pris_to_csc(g, pris)
    colors = jnp.full(vp, -1, jnp.int32)
    return ColorState(colors, pris, pri_csc, full_frontier(g),
                      jnp.full(SPRAY_K, g.pad_vertex, jnp.int32),
                      jnp.int32(g.n_vertices), jnp.asarray(False))


def _finish(state: ColorState, it, minmax_per_wave):
    """Assign colors for every wave's (max, min) sweeps; wave j of round it
    uses colors 2*(it*WAVES+j) and 2*(it*WAVES+j)+1."""
    colors, pris, frontier = state.colors, state.pris, state.frontier
    nc = colors
    newly = jnp.zeros_like(frontier)
    for j, (nbr_max, nbr_min) in enumerate(minmax_per_wave):
        p = pris[j]
        is_max = frontier & ~newly & (p > nbr_max)
        is_min = frontier & ~newly & (p < nbr_min) & ~is_max
        base = 2 * (it * WAVES + j)
        nc = jnp.where(is_max, base, nc)
        nc = jnp.where(is_min, base + 1, nc)
        newly = newly | is_max | is_min
    return nc, frontier & ~newly


def _dense_sweep(g: Graph, state: ColorState):
    """ONE uncolored-mask expansion feeds all 2*WAVES combines (the
    per-edge priorities are static)."""
    from essentials_tpu.ops.advance import _expand_and_route
    from essentials_tpu.ops.configs import AdvanceIO
    active, _ = _expand_and_route(g, state.frontier, AdvanceIO.VERTICES, ())
    # a self-loop is no neighbor: it would tie a vertex with itself
    active = active & (g.csc_src_indices != g.csc_dst_indices)
    from essentials_tpu.ops.segment import combine_by_offsets
    outs = []
    for pe in state.pri_csc:
        mx = combine_by_offsets(
            jnp.where(active, pe, -IMAX - 1), g.csc_offsets, Combine.MAX,
            g.csc_seg_flags)
        mn = combine_by_offsets(
            jnp.where(active, pe, IMAX), g.csc_offsets, Combine.MIN,
            g.csc_seg_flags)
        outs.append((mx, mn))
    return outs


def step(g: Graph, state: ColorState, it) -> ColorState:
    colors, pris, pri_csc, frontier, fidx, fcount, fvalid = state
    K = SPRAY_K
    vp = g.n_vertices_padded

    if not spray_enabled(g):
        nc, nf = _finish(state, it, _dense_sweep(g, state))
        return ColorState(nc, pris, pri_csc, nf, fidx, fcount, fvalid)

    offs, deg = jax.lax.cond(
        fvalid, lambda _: frontier_out_degree(g, fidx),
        lambda _: (jnp.zeros(K, jnp.int32), jnp.zeros(K, jnp.int32)), None)
    take_spray = fvalid & (jnp.sum(deg) <= SPRAY_BUDGET)

    def sparse(_):
        # budgeted spray: enumerate exactly the uncolored set's out-edges;
        # per-wave priorities expand by the per-segment-constant trick
        e, nb, _, valid = spray_candidates(g, fidx, offs, deg, SPRAY_BUDGET)
        valid = valid & (nb != g.src_indices[e])
        pfx = jnp.cumsum(deg) - deg
        outs = []
        for j in range(WAVES):
            pri_seg = jnp.where(fidx == g.pad_vertex, 0, pris[j][fidx])
            d = jnp.diff(pri_seg, prepend=jnp.zeros(1, jnp.int32))
            z = jnp.zeros(SPRAY_BUDGET, jnp.int32).at[pfx].add(d, mode="drop")
            pri_e = jnp.cumsum(z)
            nbr_max = jnp.full(vp, -IMAX - 1, jnp.int32).at[nb].max(
                jnp.where(valid, pri_e, -IMAX - 1), mode="drop")
            nbr_min = jnp.full(vp, IMAX, jnp.int32).at[nb].min(
                jnp.where(valid, pri_e, IMAX), mode="drop")
            outs.append((nbr_max, nbr_min))
        return tuple(outs)

    minmax = jax.lax.cond(take_spray, sparse,
                          lambda _: tuple(_dense_sweep(g, state)), None)
    nc, nf = _finish(state, it, minmax)

    def next_idx_sparse(_):
        # the uncolored set shrinks: filter the carried index list (O(K))
        keep = nf[fidx] & (fidx != g.pad_vertex)
        fi2 = jnp.sort(jnp.where(keep, fidx, jnp.int32(2**30)))
        return jnp.where(fi2 < 2**30, fi2, g.pad_vertex), jnp.sum(keep)

    def next_idx_dense(_):
        cnt = jnp.count_nonzero(nf)
        fi2 = jax.lax.cond(
            cnt <= K, lambda m: compact_frontier(m, K, g.pad_vertex),
            lambda m: jnp.full(K, g.pad_vertex, jnp.int32), nf)
        return fi2, cnt

    fi2, cnt = jax.lax.cond(fvalid, next_idx_sparse, next_idx_dense, None)
    return ColorState(nc, pris, pri_csc, nf, fi2, cnt, cnt <= K)


# ------------------------------------------------------------------ #
# speculative recolor variant ("spec"): everyone picks a hashed color from
# a per-vertex palette of size deg+1; per round, the HIGHER-(deg,id)-rank
# endpoint of every conflicting edge rehashes. Conflicts decay
# geometrically (P(re-conflict) ~ 1/(deg+1)), so round count is ~log E
# instead of Jones-Plassmann's priority-chain depth (100 rounds at rmat20
# for the JP/8-wave path). The
# detection advance runs dense only while the recolored set is large;
# the budgeted spray path covers the shrinking tail (conflicts can only
# involve a vertex recolored last round, so its out-edges suffice on
# symmetric graphs). Trades color-count quality (<= maxdeg+1, typically a
# few x chromatic) for far fewer rounds — the reference's JP
# formulation is kept as the default variant for parity
# (color.hxx:96-141).


class SpecState(NamedTuple):
    colors: jax.Array       # int32[Vp] current speculative colors
    frontier: jax.Array     # bool[Vp] recolored last round
    fidx: jax.Array         # int32[K]
    fvalid: jax.Array


def _hash_color(v, deg, it, seed):
    """Cheap avalanching integer hash -> [0, deg]."""
    x = v.astype(jnp.uint32) * jnp.uint32(2654435761)
    x = x ^ (jnp.uint32(seed * 0x9E3779B9) + jnp.uint32(it).astype(jnp.uint32) * jnp.uint32(0x85EBCA6B))
    x = (x ^ (x >> 16)) * jnp.uint32(0x45D9F3B)
    x = x ^ (x >> 16)
    return (x % (deg.astype(jnp.uint32) + 1)).astype(jnp.int32)


def init_spec(g: Graph, seed: int = 0) -> SpecState:
    vp = g.n_vertices_padded
    deg = jnp.where(g.vertex_mask(), g.out_degrees(), 0).astype(jnp.int32)
    v = jnp.arange(vp, dtype=jnp.int32)
    colors = jnp.where(g.vertex_mask(),
                       _hash_color(v, deg, jnp.int32(0), seed), -1)
    return SpecState(colors, full_frontier(g),
                     jnp.full(SPRAY_K, g.pad_vertex, jnp.int32),
                     jnp.asarray(False))


def step_spec(g: Graph, state: SpecState, it, seed: int = 0) -> SpecState:
    from essentials_tpu.ops import advance, AdvanceIO
    colors, frontier, fidx, fvalid = state
    K = SPRAY_K
    vp = g.n_vertices_padded
    deg_all = jnp.where(g.vertex_mask(), g.out_degrees(), 0).astype(jnp.int32)
    v_ids = jnp.arange(vp, dtype=jnp.int32)
    # rank = (deg, id): hubs keep their colors, leaves rehash
    rank = deg_all * jnp.int32(vp + 1) + v_ids

    def dense(_):
        # conflicted[d] = OR over edges (s->d): same color, s keeps
        def msg(e):
            return ((e.src_vals[0] == e.dst_vals[0])
                    & (e.src_vals[1] < e.dst_vals[1])).astype(jnp.int32)

        c = advance(g, msg, None, src_values=(colors, rank),
                    dst_values=(colors, rank), input_kind=AdvanceIO.GRAPH,
                    combine=Combine.MAX, with_frontier=False)
        return (c > 0) & g.vertex_mask()

    if not spray_enabled(g):
        conflicted = dense(None)
    else:
        offs, deg = jax.lax.cond(
            fvalid, lambda _: frontier_out_degree(g, fidx),
            lambda _: (jnp.zeros(K, jnp.int32), jnp.zeros(K, jnp.int32)),
            None)
        take_spray = fvalid & (jnp.sum(deg) <= SPRAY_BUDGET)

        def sparse(_):
            # conflicts only involve last-round recolored vertices: spray
            # their out-edges, scatter the higher-rank endpoint of every
            # same-color pair (both directions covered: src expansion
            # carries s, nb carries n)
            e, nb, src_e, valid = spray_candidates(g, fidx, offs, deg,
                                                   SPRAY_BUDGET,
                                                   with_src=True)
            same = valid & (colors[src_e] == colors[nb]) \
                & (nb != src_e)
            s_keeps = rank[src_e] < rank[nb]
            hit_n = same & s_keeps
            hit_s = same & ~s_keeps
            c = jnp.zeros(vp, jnp.int8)
            c = c.at[nb].max(hit_n.astype(jnp.int8), mode="drop")
            c = c.at[src_e].max(hit_s.astype(jnp.int8), mode="drop")
            return (c > 0) & g.vertex_mask()

        conflicted = jax.lax.cond(take_spray, sparse, dense, None)

    nc = jnp.where(conflicted,
                   _hash_color(v_ids, deg_all, it + 1, seed), colors)
    cnt = jnp.count_nonzero(conflicted)
    fi2 = jax.lax.cond(
        cnt <= K, lambda m: compact_frontier(m, K, g.pad_vertex),
        lambda m: jnp.full(K, g.pad_vertex, jnp.int32), conflicted)
    return SpecState(nc, conflicted, fi2, cnt <= K)


def run(g: Graph, *, seed: int = 0, max_iterations: int | None = None,
        warmup: bool = True, variant: str = "auto") -> ColorResult:
    """variant: 'auto' (static heuristic — see below), 'jp'
    (Jones-Plassmann 8-wave, reference parity) or 'spec' (speculative
    recolor — ~log-round convergence, more colors).

    'auto' picks 'spec' exactly where JP's cost model explodes: above the
    spray threshold the dense sweep costs O(E) and JP's priority-chain
    depth multiplies it; below it JP's better color count wins."""
    max_it = max_iterations if max_iterations is not None else g.n_vertices + 1
    if variant == "auto":
        variant = "spec" if spray_enabled(g) else "jp"
    if variant == "spec":
        res: EnactResult = enact(step_spec, default_converged, g,
                                 init_spec(g, seed),
                                 max_iterations=max_it, warmup=warmup)
        return ColorResult(res.state.colors[:g.n_vertices], res.iterations,
                           res.elapsed_ms)
    res = enact(step, default_converged, g, init(g, seed),
                max_iterations=max_it, warmup=warmup)
    return ColorResult(res.state.colors[:g.n_vertices], res.iterations,
                       res.elapsed_ms)


def validate(csr, colors: np.ndarray) -> int:
    """Count conflicting edges (endpoints sharing a color) + uncolored
    vertices (reference parity: examples/algorithms/color validation)."""
    colors = np.asarray(colors)
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    src = np.repeat(np.arange(csr.n_rows), np.diff(off))
    conflicts = int(np.sum((colors[src] == colors[cols]) & (src != cols)))
    return conflicts + int(np.sum(colors < 0))
