"""Minimum spanning forest (Borůvka).

Reference parity: gunrock::mst (/root/reference/include/gunrock/algorithms/
mst.hxx:95-260): per round, each supervertex picks its min-weight outgoing
edge (atomicMin + tiebreak there), merges, pointer-jumps. Here the
whole round is segment-MIN reductions keyed by component id plus a
fixed-depth pointer-jumping loop; mutual hooks are broken by hooking the
larger root under the smaller; weight ties break on a *canonical undirected
edge key* so both endpoints of a tie agree on the same edge (the reference
instead documents its float-atomic nondeterminism, mst.hxx:196-199 — here
the result is deterministic).

Works on undirected graphs stored with both directed copies present.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.framework.enactor import enact, EnactResult
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops.segment import segment_combine
from essentials_tpu.ops.configs import Combine

INT_MAX = jnp.iinfo(jnp.int32).max


class MstState(NamedTuple):
    comp: jax.Array        # int32[Vp] component (root) per vertex
    in_mst: jax.Array      # bool[Ep] chosen edges (CSR edge-id order)
    changed: jax.Array     # did the last round merge anything


class MstResult(NamedTuple):
    in_mst: jax.Array      # bool[E] over CSR edge ids (one direction chosen)
    total_weight: float
    iterations: int
    elapsed_ms: float


def init(g: Graph) -> MstState:
    vp = g.n_vertices_padded
    comp = jnp.arange(vp, dtype=jnp.int32)
    return MstState(comp, jnp.zeros(g.n_edges_padded, jnp.bool_),
                    jnp.asarray(True))


def _float_order_key(w: jax.Array) -> jax.Array:
    """Order-preserving float32 -> int32 map (signed comparison)."""
    i = jax.lax.bitcast_convert_type(w.astype(jnp.float32), jnp.int32)
    flip = jnp.bitwise_and(jax.lax.shift_right_arithmetic(i, 31),
                           jnp.int32(0x7FFFFFFF))
    return jnp.bitwise_xor(i, flip)


def _expand_by_src(g: Graph, vals):
    from essentials_tpu.ops.advance import _expand_src_multi
    return _expand_src_multi(g, vals)


def _expand_by_dst_to_csr(g: Graph, v):
    """v[dst(e)] on the CSR edge axis: expand over the CSC offsets, permute
    CSC->CSR."""
    from essentials_tpu.ops.segment import (expand_vertex_to_edges,
                                            apply_permutation)
    ep = g.n_edges_padded
    exp = expand_vertex_to_edges(v, g.csc_offsets, ep)
    return apply_permutation(g.csc_edge_ids, exp)


def _combine_src_min(g: Graph, vals: jax.Array) -> jax.Array:
    from essentials_tpu.ops.segment import combine_by_offsets
    return combine_by_offsets(vals, g.row_offsets, Combine.MIN,
                              g.csr_seg_flags)


def step(g: Graph, state: MstState, it) -> MstState:
    """One Borůvka round, two-level argmin:

    edge level (static CSR segments, gather-free engine): per VERTEX, the
    lexicographic-min cross edge (weight, then dst) — valid pre-reduction
    because comp is constant within a vertex's out-edges, and within one
    vertex min-dst IS the canonical-undirected-key order. A fourth
    combine extracts the winner's TARGET COMPONENT (comp_dst at the
    winning edge) so the vertex level needs no comp[col[e]] gather.

    vertex level: per-COMPONENT winner by ONE 4-key device sort
    (comp, w, cu, cv) — group heads are the argmins.
    Pointer jumping carries its convergence flag in the loop state so
    each iteration costs ONE gather, not two."""
    comp, in_mst, _ = state
    vp = g.n_vertices_padded
    ep = g.n_edges_padded
    iota_v = jnp.arange(vp, dtype=jnp.int32)

    # --- edge level: engine chains over static src segments ---
    comp_src = _expand_by_src(g, (comp,))[0]
    comp_dst = _expand_by_dst_to_csr(g, comp)
    cross = (comp_src != comp_dst) & g.edge_mask()

    wkey = jnp.where(cross, _float_order_key(g.values), INT_MAX)
    wmin_v = _combine_src_min(g, wkey)                      # [Vp]
    wmin_e = _expand_by_src(g, (jnp.where(wmin_v == INT_MAX, INT_MAX - 1,
                                          wmin_v),))[0]
    at_min = cross & (wkey == wmin_e)
    dx = jnp.where(at_min, g.col_indices, INT_MAX)
    dmin_v = _combine_src_min(g, dx)                        # [Vp]
    dmin_e = _expand_by_src(g, (jnp.where(dmin_v == INT_MAX, INT_MAX - 1,
                                          dmin_v),))[0]
    eid = jnp.arange(ep, dtype=jnp.int32)
    at_win = at_min & (g.col_indices == dmin_e)
    ex = jnp.where(at_win, eid, INT_MAX)
    emin_v = _combine_src_min(g, ex)                        # [Vp] winner eid
    tx = jnp.where(at_win, comp_dst, INT_MAX)
    tcomp_v = _combine_src_min(g, tx)                       # [Vp] target comp

    # --- vertex level: per-component lexicographic (w, cu, cv) winner
    # via one multi-key sort; group heads are the argmins ---
    cu = jnp.minimum(iota_v, dmin_v)
    cv = jnp.maximum(iota_v, dmin_v)
    comp_s, w_s, cu_s, cv_s, e_s, t_s = jax.lax.sort(
        (comp, wmin_v, cu, cv, emin_v, tcomp_v), num_keys=4)
    prev = jnp.concatenate([jnp.full(1, -1, jnp.int32), comp_s[:-1]])
    winner = (comp_s != prev) & (w_s < INT_MAX)

    # hook each winning root under its target root (scatter at unique
    # ascending root slots; non-winners drop out of bounds)
    parent = iota_v.at[jnp.where(winner, comp_s, vp)].set(
        jnp.where(winner, t_s, 0), mode="drop")

    # resolve mutual hooks: the smaller root stays a root
    mutual = (parent[parent] == iota_v) & (iota_v < parent)
    parent = jnp.where(mutual, iota_v, parent)

    # record each actually-hooking component's chosen edge (the mutual
    # winner stays a root; its partner records their shared edge)
    hooked_root = parent != iota_v                          # [Vp] by root id
    rec = winner & hooked_root[comp_s]
    in_mst = in_mst.at[jnp.where(rec, e_s, ep)].max(
        rec, mode="drop")

    # pointer jumping until stable, convergence flag carried in-loop
    # (ONE gather per iteration). BOUNDED: malformed inputs (asymmetric
    # weights on an "undirected" graph) can produce hook cycles; the
    # bound turns a device hang into a wrong-but-terminating answer the
    # validator catches.
    depth = max(int(np.ceil(np.log2(max(vp, 2)))), 1) + 2

    def not_flat(c):
        p, go, i = c
        return go & (i < depth)

    def jump(c):
        p, _, i = c
        p2 = p[p]
        return p2, jnp.any(p2 != p), i + 1

    parent, _, _ = jax.lax.while_loop(
        not_flat, jump, (parent, jnp.asarray(True), jnp.int32(0)))
    new_comp = parent[comp]

    changed = jnp.any(winner)
    return MstState(new_comp, in_mst, changed)


def converged(g: Graph, state: MstState, it) -> jax.Array:
    return jnp.logical_not(state.changed)


def run(g: Graph, *, max_iterations: int | None = None,
        warmup: bool = True) -> MstResult:
    max_it = max_iterations if max_iterations is not None else \
        max(int(np.ceil(np.log2(max(g.n_vertices, 2)))) + 2, 3)
    res: EnactResult = enact(step, converged, g, init(g),
                             max_iterations=max_it, warmup=warmup)
    in_mst = res.state.in_mst[:g.n_edges]
    total = float(jnp.sum(jnp.where(in_mst, g.values[:g.n_edges], 0.0)))
    return MstResult(in_mst, total, res.iterations, res.elapsed_ms)


def cpu_reference(csr) -> float:
    """Host Kruskal total-weight reference (reference parity:
    examples/algorithms/mst/mst_cpu.hxx)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values, np.float64)
    src = np.repeat(np.arange(n), np.diff(off))
    keep = src < cols  # one copy per undirected edge
    edges = sorted(zip(vals[keep], src[keep], cols[keep]))
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    total = 0.0
    for w, u, v in edges:
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[ru] = rv
            total += w
    return total
