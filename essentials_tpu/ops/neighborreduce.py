"""neighborreduce: per-vertex reduction over incident out-edges.

Reference parity: operators::neighborreduce::execute via mgpu
transform_segreduce (/root/reference/include/gunrock/framework/operators/
neighborreduce/neighborreduce.hxx:55-101). Mirror of advance:
dst-keyed vertex arrays are expanded on the CSC side (where dst is sorted)
and routed CSC->CSR with one permutation sort; src-keyed arrays expand
directly over row_offsets; the combine is keyed by source via the CSR
offsets. This is SpMV's engine: y[s] = reduce_{(s->d,w)} w * x[d].
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from essentials_tpu.graph.graph import Graph
from essentials_tpu.ops.advance import Edges, _expand_src_multi
from essentials_tpu.ops.configs import Combine
from essentials_tpu.ops.segment import (
    combine_identity, combine_by_offsets, expand_vertex_to_edges,
    apply_permutation)


def neighbor_reduce(g: Graph, message_fn: Callable, *,
                    src_values: Sequence[jax.Array] = (),
                    dst_values: Sequence[jax.Array] = (),
                    combine: Combine = Combine.SUM) -> jax.Array:
    """``message_fn(Edges) -> per-edge values`` ([Ep], CSR order); returns
    the [Vp] per-source combine (identity at sourceless/pad slots).

    The Edges view here is in CSR order: src sorted, dst arbitrary.
    Declare vertex-array dependencies via src_values/dst_values — do not
    index vertex arrays inside the closure.
    """
    ep = g.n_edges_padded
    src_vals = _expand_src_multi(g, tuple(src_values))
    if dst_values:
        expanded = [expand_vertex_to_edges(v, g.csc_offsets, ep)
                    for v in dst_values]
        routed = apply_permutation(g.csc_edge_ids, *expanded)
        dst_vals = (routed,) if len(expanded) == 1 else tuple(routed)
    else:
        dst_vals = ()

    eids = jnp.arange(ep, dtype=jnp.int32)
    edges = Edges(src=g.src_indices, dst=g.col_indices, eid=eids,
                  weight=g.values, active=g.edge_mask(),
                  src_vals=src_vals, dst_vals=dst_vals)
    vals = message_fn(edges)
    vals = jnp.broadcast_to(jnp.asarray(vals), (ep,))
    ident = combine_identity(combine, vals.dtype)
    vals = jnp.where(edges.active, vals, ident)
    return combine_by_offsets(vals, g.row_offsets, combine, g.csr_seg_flags)
