"""Advance: frontier -> neighbor expansion with deterministic combine.

Reference parity: operators::advance::execute and its load-balance kernels
(/root/reference/include/gunrock/framework/operators/advance/advance.hxx:91-221,
block_mapped.hxx:38-147, merge_path.hxx:89-113), on the segment engine of
ops/segment.py:

  CSR side   expand the frontier and any src-keyed vertex arrays to the
             edge axis (telescoping int32 cumsum — exact, no gather);
  routing    ONE multi-payload lax.sort applies the static CSR->CSC
             permutation to everything that crosses from source side to
             destination side;
  CSC side   expand dst-keyed vertex arrays directly (dst is sorted here),
             evaluate the per-edge message elementwise, and combine per
             destination with offset-based cumsum/segmented-scan reductions.

The message closure receives an `Edges` view whose fields are all [Ep]
arrays in CSC order — it must stay elementwise (no indexing into vertex
arrays; declare those via src_values/dst_values instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from essentials_tpu.errors import throw_if
from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops.configs import Combine, AdvanceIO
from essentials_tpu.ops.segment import (
    combine_identity, combine_by_offsets, expand_vertex_to_edges,
    apply_permutation)


def _expand_src_multi(g: Graph, vals):
    """Expand src-keyed vertex arrays to the CSR edge axis."""
    return tuple(expand_vertex_to_edges(v, g.row_offsets, g.n_edges_padded)
                 for v in vals)


def _expand_dst(g: Graph, v):
    """Expand a dst-keyed vertex array to the CSC edge axis."""
    return expand_vertex_to_edges(v, g.csc_offsets, g.n_edges_padded)


def _combine_dst(g: Graph, msg, combine: Combine):
    """Segmented combine per destination (CSC order)."""
    return combine_by_offsets(msg, g.csc_offsets, combine, g.csc_seg_flags)


@dataclass(frozen=True)
class Edges:
    """Per-edge view handed to message closures ([Ep] arrays, CSC order)."""
    src: jax.Array          # source vertex ids (static)
    dst: jax.Array          # destination vertex ids (static, sorted)
    eid: jax.Array          # CSR edge ids (static)
    weight: jax.Array       # edge weights
    active: jax.Array       # bool: source-active mask
    src_vals: tuple         # src_values expanded to edges (via src)
    dst_vals: tuple         # dst_values expanded to edges (via dst)


def _expand_and_route(g: Graph, frontier, input_kind: AdvanceIO,
                      src_values: Sequence[jax.Array]):
    """CSR-side expansion + one permutation sort into CSC order.

    Returns (active_csc bool[Ep], src_vals_csc tuple)."""
    throw_if(not g.has_csc, "advance requires the CSC (dst-sorted) view")
    ep = g.n_edges_padded

    to_expand = list(src_values)
    static_active = None
    edge_payload = None
    if input_kind == AdvanceIO.GRAPH or frontier is None:
        # all real edges active; in CSC order pad edges sort last -> static
        static_active = jnp.arange(ep) < g.n_edges
    elif input_kind == AdvanceIO.VERTICES:
        to_expand.append(frontier.astype(jnp.int8))
    elif input_kind == AdvanceIO.EDGES:
        edge_payload = frontier.astype(jnp.int8)    # already per-edge (CSR)
    else:
        raise ValueError(input_kind)

    payloads = list(_expand_src_multi(g, to_expand)) if to_expand else []
    if edge_payload is not None:
        payloads.append(edge_payload)

    if payloads:
        routed = apply_permutation(g.csc_rank, *payloads)
        if len(payloads) == 1:
            routed = (routed,)
    else:
        routed = ()

    if static_active is None:
        active = routed[-1] != 0
        src_vals = tuple(routed[:-1])
    else:
        active = static_active
        src_vals = tuple(routed)
    return active, src_vals


def advance_multi(g: Graph,
                  messages: Sequence[tuple],
                  frontier: jax.Array | None = None,
                  *,
                  src_values: Sequence[jax.Array] = (),
                  dst_values: Sequence[jax.Array] = (),
                  input_kind: AdvanceIO = AdvanceIO.VERTICES,
                  with_frontier: bool = False):
    """Run several (message_fn, combine) pairs over ONE expansion + routing.

    Each message_fn: ``Edges -> msg [Ep]`` or ``-> (msg, cond)``. Returns a
    list of combined [Vp] arrays (+ the OR'd output frontier if requested,
    built from every message's cond — cond=None means "active edges fire").
    """
    active, src_vals = _expand_and_route(g, frontier, input_kind, src_values)
    dst_vals = tuple(_expand_dst(g, v) for v in dst_values)
    edges = Edges(src=g.csc_src_indices, dst=g.csc_dst_indices,
                  eid=g.csc_edge_ids, weight=g.csc_values, active=active,
                  src_vals=src_vals, dst_vals=dst_vals)

    outs = []
    fired_any = None
    for message_fn, combine in messages:
        out = message_fn(edges)
        msg, cond = out if isinstance(out, tuple) else (out, None)
        msg = jnp.broadcast_to(jnp.asarray(msg), active.shape)
        ident = combine_identity(combine, msg.dtype)
        msg = jnp.where(active, msg, ident)
        outs.append(_combine_dst(g, msg, combine))
        if with_frontier:
            fired = active if cond is None else (active & cond)
            fired_any = fired if fired_any is None else (fired_any | fired)

    if with_frontier:
        out_frontier = _combine_dst(g, fired_any, Combine.OR)
        out_frontier = out_frontier & g.vertex_mask()
        return outs, out_frontier
    return outs


def advance_count(g: Graph, frontier: jax.Array) -> jax.Array:
    """#active in-edges per destination, int32[Vp]. OR-reach is
    ``advance_count(...) > 0``.

    Reference parity: the operators::advance + OR/SUM-combine special case
    (advance/advance.hxx:91-221 with a counting/marking functor), which is
    the hot superstep of BFS-like algorithms."""
    res = advance_multi(g, [(lambda e: 1, Combine.SUM)], frontier,
                        with_frontier=False)
    return res[0]


def advance(g: Graph,
            message_fn: Callable,
            frontier: jax.Array | None = None,
            *,
            src_values: Sequence[jax.Array] = (),
            dst_values: Sequence[jax.Array] = (),
            combine: Combine = Combine.MIN,
            input_kind: AdvanceIO = AdvanceIO.VERTICES,
            with_frontier: bool = True):
    """Single-message advance. ``message_fn(Edges) -> msg | (msg, cond)``.

    Returns ``combined [Vp]`` (+ ``out_frontier bool[Vp]`` unless
    ``with_frontier=False``)."""
    res = advance_multi(g, [(message_fn, combine)], frontier,
                        src_values=src_values, dst_values=dst_values,
                        input_kind=input_kind, with_frontier=with_frontier)
    if with_frontier:
        outs, out_frontier = res
        return outs[0], out_frontier
    return res[0]


def advance_edges(g: Graph,
                  message_fn: Callable,
                  frontier: jax.Array | None = None,
                  *,
                  src_values: Sequence[jax.Array] = (),
                  dst_values: Sequence[jax.Array] = (),
                  input_kind: AdvanceIO = AdvanceIO.VERTICES) -> jax.Array:
    """Advance producing an *edge* frontier: bool[Ep] in CSR edge-id order.

    ``message_fn(Edges) -> cond bool[Ep]`` (CSC order); the result is
    routed back to CSR order with the inverse permutation sort. Used by
    edge-frontier algorithms (MST) — frontier_kind_t::edge_frontier parity.
    """
    active, src_vals = _expand_and_route(g, frontier, input_kind, src_values)
    dst_vals = tuple(_expand_dst(g, v) for v in dst_values)
    edges = Edges(src=g.csc_src_indices, dst=g.csc_dst_indices,
                  eid=g.csc_edge_ids, weight=g.csc_values, active=active,
                  src_vals=src_vals, dst_vals=dst_vals)
    cond = message_fn(edges)
    fired = (active & cond).astype(jnp.int8)
    # route back CSC -> CSR: csc_edge_ids IS the inverse rank permutation
    back = apply_permutation(g.csc_edge_ids, fired)
    return (back != 0) & g.edge_mask()
