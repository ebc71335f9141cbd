"""Segment engine: expansion, permutation, and combines over the edge axis.

The engine keeps every edge-axis step a bulk primitive (cumsum, sort,
associative scan); arbitrary indexing touches only V-sized arrays:

* expand_vertex_to_edges — broadcast per-vertex values to their (sorted)
  edge slots: bitcast values to int32, take vertex-axis diffs, scatter-add
  the diffs at the V segment-start offsets, int32-cumsum over the edge axis
  (wrap-around makes the telescoping EXACT bit-for-bit), bitcast back.

* apply_permutation — move edge arrays between CSR order and CSC order via
  one `lax.sort` keyed by the static rank permutation (multiple payloads
  ride one sort).

* combine_by_offsets — segmented reduction over a sorted edge order using
  the segment offsets: SUM/OR/AND via cumsum + boundary arithmetic (int32
  exact), MIN/MAX via a segmented associative scan with static reset flags.

On a GPU the permutation and the expansion are each one gather
(``x[csc_edge_ids]``, ``x[src]``); replacing the sort and the telescoping
cumsum with them is tracked as ROADMAP debt D1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from essentials_tpu.ops.configs import Combine
from essentials_tpu.ops.scan_kernels import cumsum as _cumsum
from essentials_tpu.ops.scan_kernels import segmented_scan as _segscan


def combine_identity(combine: Combine, dtype):
    dt = jnp.dtype(dtype)
    if combine == Combine.SUM:
        return dt.type(0)
    if combine == Combine.OR:
        return False
    if combine == Combine.AND:
        return True
    if combine == Combine.MIN:
        return dt.type(jnp.inf) if jnp.issubdtype(dt, jnp.floating) else jnp.iinfo(dt).max
    if combine == Combine.MAX:
        return dt.type(-jnp.inf) if jnp.issubdtype(dt, jnp.floating) else jnp.iinfo(dt).min
    raise ValueError(combine)


# --------------------------------------------------------------------- #
# bit-exact int32 round trip for the telescoping expansion

def _to_i32(x: jax.Array) -> jax.Array:
    if x.dtype == jnp.int32:
        return x
    if x.dtype in (jnp.float32, jnp.uint32):
        return jax.lax.bitcast_convert_type(x, jnp.int32)
    return x.astype(jnp.int32)  # bool / int8 / int16


def _from_i32(x: jax.Array, dtype) -> jax.Array:
    dt = jnp.dtype(dtype)
    if dt == jnp.int32:
        return x
    if dt in (jnp.float32, jnp.uint32):
        return jax.lax.bitcast_convert_type(x, dt)
    if dt == jnp.bool_:
        return x != 0
    return x.astype(dt)


def expand_vertex_to_edges(vertex_vals: jax.Array, offsets: jax.Array,
                           n_edges_padded: int) -> jax.Array:
    """Broadcast vertex_vals[v] to every edge slot of segment v.

    ``offsets``: [n_segments + 1] sorted segment offsets covering the whole
    padded edge axis (offsets[-1] == n_edges_padded). Exact for all dtypes
    (int32 wrap-around telescoping)."""
    iv = _to_i32(vertex_vals)
    d = jnp.diff(iv, prepend=jnp.zeros(1, jnp.int32))
    z = jnp.zeros(n_edges_padded + 1, jnp.int32).at[offsets[:-1]].add(d)
    return _from_i32(_cumsum(z[:n_edges_padded]), vertex_vals.dtype)


def apply_permutation(rank: jax.Array, *payloads: jax.Array):
    """Reorder each payload so slot rank[e] receives payload[e] — i.e. the
    result R satisfies R[rank[e]] = payload[e]. One multi-operand sort."""
    out = jax.lax.sort((rank,) + tuple(payloads), num_keys=1)
    return out[1:] if len(payloads) > 1 else out[1]


def combine_by_offsets(edge_vals: jax.Array, offsets: jax.Array,
                       combine: Combine, seg_flags: jax.Array | None = None
                       ) -> jax.Array:
    """Segmented reduction over a sorted edge order; [n_segments] output,
    identity at empty segments. MIN/MAX require ``seg_flags`` (static
    segment-start flags over the edge axis)."""
    lo_off = offsets[:-1]
    hi_off = offsets[1:]
    nonempty = hi_off > lo_off

    # Segments tile the edge axis contiguously, so the low boundary prefix
    # equals the previous segment's high boundary: lo = shift(hi, 1). One
    # V-sized gather instead of two.
    def _boundary_diff(s, zero):
        hi = s[jnp.maximum(hi_off - 1, 0)]
        lo = jnp.concatenate([jnp.full((1,), zero, s.dtype), hi[:-1]])
        lo = jnp.where(lo_off > 0, lo, zero)
        return hi - lo

    if combine in (Combine.OR, Combine.AND):
        cnt = _boundary_diff(_cumsum(edge_vals.astype(jnp.int32)), 0)
        cnt = jnp.where(nonempty, cnt, 0)
        if combine == Combine.OR:
            return cnt > 0
        return nonempty & (cnt == hi_off - lo_off) | ~nonempty  # vacuous True

    if combine == Combine.SUM:
        # int32: exact via wrap-around prefix difference. float32: prefer a
        # SEGMENTED scan (global-cumsum differences accumulate
        # O(n*eps*prefix) error at 10M+ edges); falls back to the prefix
        # difference when no segment flags are available.
        if jnp.issubdtype(edge_vals.dtype, jnp.integer) or \
                edge_vals.dtype == jnp.bool_:
            out = _boundary_diff(_cumsum(_to_i32(edge_vals)), 0)
            return jnp.where(nonempty, out, 0).astype(edge_vals.dtype)
        if seg_flags is not None:
            sv = _segscan(edge_vals.astype(jnp.float32), seg_flags, "add")
            out = sv[jnp.maximum(hi_off - 1, 0)]
            return jnp.where(nonempty, out, 0.0).astype(edge_vals.dtype)
        out = _boundary_diff(_cumsum(edge_vals.astype(jnp.float32)), 0.0)
        return jnp.where(nonempty, out, 0.0).astype(edge_vals.dtype)

    # MIN / MAX: segmented scan with reset flags
    assert seg_flags is not None, "MIN/MAX combine needs segment-start flags"
    ident = combine_identity(combine, edge_vals.dtype)
    opname = "min" if combine == Combine.MIN else "max"
    dt = edge_vals.dtype
    carrier = edge_vals
    if dt not in (jnp.int32, jnp.float32):
        carrier = carrier.astype(jnp.float32
                                 if jnp.issubdtype(dt, jnp.floating)
                                 else jnp.int32)
    sv = _segscan(carrier, seg_flags, opname).astype(dt)
    out = sv[jnp.maximum(hi_off - 1, 0)]
    return jnp.where(nonempty, out, ident)


# --------------------------------------------------------------------- #
# generic keyed fallback (unsorted keys, e.g. MST component ids)

def segment_combine(data: jax.Array, segment_ids: jax.Array, num_segments: int,
                    combine: Combine, *, indices_are_sorted: bool = True
                    ) -> jax.Array:
    """Keyed segmented reduction via jax.ops (unsorted keys allowed)."""
    kw = dict(num_segments=num_segments, indices_are_sorted=indices_are_sorted)
    if combine == Combine.SUM:
        return jax.ops.segment_sum(data, segment_ids, **kw)
    if combine == Combine.MIN:
        return jax.ops.segment_min(data, segment_ids, **kw)
    if combine == Combine.MAX:
        return jax.ops.segment_max(data, segment_ids, **kw)
    if combine == Combine.OR:
        out = jax.ops.segment_max(data.astype(jnp.int8), segment_ids, **kw)
        return out > 0
    if combine == Combine.AND:
        out = jax.ops.segment_min(data.astype(jnp.int8), segment_ids, **kw)
        return out > 0
    raise ValueError(combine)
