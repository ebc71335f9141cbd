"""Inclusive scans over the edge axis: cumsum and segmented scans.

Segmented variants scan (value, start_flag) pairs with the standard
associative operator  (v1,f1)·(v2,f2) = (f2 ? v2 : op(v1,v2), f1|f2),
giving per-segment inclusive MIN/MAX/SUM without materializing segment ids.
int32 sums wrap around exactly, which the telescoping expansion in
ops/segment.py relies on.

Reference parity: replaces CUB BlockScan + cub::DeviceScan use inside the
reference's advance kernels (block_mapped.hxx:84-87) at the whole-edge-axis
level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _op_fn(op: str):
    # "first" (keep the older value) is associative; with a segment-start
    # flag at position 0 it implements forward-fill over runs.
    return {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum,
            "first": lambda a, b: a}[op]


def segmented_minmax(x: jax.Array, flags: jax.Array, active: jax.Array):
    """Per-segment (MAX, MIN) inclusive scans over active int32 elements."""
    x = jnp.asarray(x, jnp.int32)
    imax = jnp.iinfo(jnp.int32).max
    return (segmented_scan(jnp.where(active, x, -imax - 1), flags, "max"),
            segmented_scan(jnp.where(active, x, imax), flags, "min"))


def cumsum(x: jax.Array) -> jax.Array:
    """Inclusive cumsum (int32 wraps around exactly)."""
    return jnp.cumsum(jnp.asarray(x))


def segmented_scan(x: jax.Array, flags: jax.Array, op: str) -> jax.Array:
    """Segmented inclusive scan; ``flags`` marks segment starts (position 0
    always starts a segment). ``op``: add | min | max | first."""
    x = jnp.asarray(x)
    flags = jnp.asarray(flags)
    opf = _op_fn(op)
    flags = flags.at[0].set(True)

    def scan_op(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, opf(av, bv)), af | bf

    sv, _ = jax.lax.associative_scan(scan_op, (x, flags))
    return sv
